"""The Silesia mix: its generator gives the same bytes on every machine,
lists the corpus's 12 files at their sizes and makes each in its kind; the
readers of the program's slot counters."""

import json
import os
import sys
import types

import pytest

import tiny
import tiny_silesia

pytest.importorskip("numpy")
import numpy as np  # noqa: E402
from harness import Cell, load_module  # noqa: E402

# the tiny parameter set's digest, pinned: the same seed must give the same
# bytes under any numpy, any Python 3.12 and any machine
PINNED = {2 ** 31 + 5: "ba6b0b1fe373ee16"}

# the Silesia corpus (Deorowicz 2003): name, bytes
SILESIA = [
    ("dickens", 10192446), ("mozilla", 51220480), ("mr", 9970564), ("nci", 33553445),
    ("ooffice", 6152192), ("osdb", 10085684), ("reymont", 6627202), ("samba", 21606400),
    ("sao", 7251944), ("webster", 41458703), ("xml", 5345280), ("x-ray", 8474240),
]


@pytest.fixture(scope="module")
def gen():
    return load_module(os.path.join(tiny.PB, "gen", "silesia.py"), "portbench_gen_silesia")


@pytest.fixture(scope="module")
def src(gen):
    return gen.make(2 ** 31 + 5, tiny_silesia.TINY_SILESIA)


def files(src):
    return {name: o for (name, _, _), o in zip(src.p["files"], src.objects)}


def test_seed_gives_same_bytes(gen, src):
    a, b = src, gen.make(2 ** 31 + 5, tiny_silesia.TINY_SILESIA)
    c = gen.make(6, tiny_silesia.TINY_SILESIA)
    assert a.digest() == b.digest() != c.digest()
    assert [a.item(i) for i in range(3)] == [b.item(i) for i in range(3)]
    assert all(x != y for x, y in zip(a.objects, c.objects))
    assert a.digest() == PINNED[2 ** 31 + 5]


def test_files_are_the_corpus_files(gen, src):
    with open(os.path.join(tiny.PB, "traffic", "silesia-files.json")) as f:
        mix = json.load(f)
    p = mix["params"]
    assert [(name, n) for name, n, _ in p["files"]] == SILESIA
    assert sum(n for _, n in SILESIA) == 211_938_580
    assert sorted(kind for _, _, kind in p["files"]) == sorted(gen.KINDS)
    assert mix["trace_inputs"] == 12 and mix["check"] == {"prefix_bytes": 4096}
    want = [n for _, n, _ in tiny_silesia.TINY_SILESIA["files"]]
    assert [len(o) for o in src.objects] == src.sizes() == want
    # every pass replays every file once, in its own order
    assert sorted(src.order(0)) == list(range(12)) and src.order(0) != src.order(1)
    with pytest.raises(ValueError):
        gen.make(3, dict(files=[["z", 100, "poem"]], vocabulary=600))


def test_full_size_segments_and_batches():
    """31 segments of 8 MiB or less, in 14 batches of 4, 25 of whose 56
    slots are padding copies; the warm-up's buckets are 128 KiB, 1 MiB,
    2 MiB and 8 MiB."""
    import harness

    seg = 1 << 23
    segs = [-(-n // seg) for _, n in SILESIA]
    batches = sum(-(-s // 4) for s in segs)
    assert (sum(segs), batches, 4 * batches - sum(segs)) == (31, 14, 25)
    warm = harness.warmup_sizes([n for _, n in SILESIA], seg)
    assert [harness.bucket(n) for n in warm] == [1 << 17, 1 << 20, 1 << 21, 1 << 23]


def _tar_members(data: bytes):
    """(name, size) of each member, checking each header's checksum."""
    out, at = [], 0
    while at + 512 <= len(data) and any(data[at:at + 512]):
        h = bytearray(data[at:at + 512])
        stored = int(h[148:154], 8)
        h[148:156] = b" " * 8
        assert stored == sum(h)
        assert h[257:263] == b"ustar\0"
        size = int(h[124:135], 8)
        out.append((bytes(h[:100]).rstrip(b"\0"), size))
        at += 512 + -(-size // 512) * 512
    assert not any(data[at:])  # zeros to the end
    return out


def test_kinds_keep_their_shapes(src):
    f = files(src)
    for name, root, suffixes in (("mozilla", b"mozilla/", (b".so", b".html", b".js")),
                                 ("samba", b"samba-2.2.3a/source/", (b".c", b".txt", b".html")),
                                 ("xml", b"xml/", (b".xml",))):
        members = _tar_members(f[name])
        assert members and all(m.startswith(root) and m.endswith(suffixes)
                               for m, _ in members), name
    xray = np.frombuffer(f["x-ray"][16:16 + (len(f["x-ray"]) - 16) // 2 * 2], "<u2")
    assert xray.max() < 1 << 12 and xray.max() > xray.min()
    mr = f["mr"]
    assert mr[128:132] == b"DICM"
    sao = f["sao"]
    assert len(sao) % 28 == 0
    head = np.frombuffer(sao[:28], "<i4")
    count = int(head[2])
    assert count == len(sao) // 28 - 1
    recs = np.frombuffer(sao[28:], np.uint8).reshape(count, 28)
    ra = recs[:, :8].copy().view("<f8")[:, 0]
    dec = recs[:, 8:16].copy().view("<f8")[:, 0]
    assert (np.diff(ra) >= 0).all() and 0 <= ra[0] and ra[-1] < 6.2832
    assert (np.abs(dec) <= 1.5708).all()
    nci = f["nci"]
    assert nci.count(b"M  END\n") >= 1 and b"$$$$\n" in nci and b" V2000\n" in nci
    osdb = f["osdb"]
    keys = np.frombuffer(osdb[:len(osdb) // 175 * 175], np.uint8).reshape(-1, 175)[:, 1:5]
    assert (keys.copy().view("<i4")[:, 0] == np.arange(1, len(keys) + 1)).all()
    reymont = f["reymont"]
    assert reymont.startswith(b"%PDF-1.") and reymont.endswith(b"%%EOF\n")
    assert b") Tj T*\n(" in reymont and any(c in reymont for c in b"\xb1\xea\xb3\xbf")
    assert f["ooffice"].startswith(b"MZ") and b"PE\0\0" in f["ooffice"][:512]
    webster = f["webster"]
    heads = [w.split(b"</hw>")[0].replace(b"*", b"").lower()
             for w in webster.split(b"<hw>")[1:-1]]
    assert len(heads) >= 2 and heads == sorted(heads)


def test_cell_resolves():
    c = Cell("l2-silesia")
    assert c.traffic["generator"] == "silesia"
    assert c.config["encode"] == Cell("l2-enwik8").config["encode"]
    assert c.config["env"] == {} and c.cell["chips"] == 1
    trace = {m["name"] for m in c.metrics(True)}
    assert {"pad_share", "staged_segments", "otz1_fallbacks"} <= trace


def _reader(name):
    return load_module(os.path.join(tiny.PB, "metrics", name + ".py"),
                       "portbench_metric_" + name)


@pytest.mark.parametrize("slots,pads,want", [(128, 62, 48.4375), (4, 0, 0.0), (8, 3, 37.5)])
def test_pad_share_reads_the_program(monkeypatch, slots, pads, want):
    mod = types.ModuleType("orz_tpu_torch.device.pcontainer")
    mod.batch_slots, mod.pad_slots = slots, pads
    monkeypatch.setitem(sys.modules, "orz_tpu_torch.device.pcontainer", mod)
    assert _reader("pad_share").read({}) == pytest.approx(want, rel=0, abs=1e-12)


@pytest.mark.parametrize("n", [0, 3, 12])
def test_staged_segments_reads_the_program(monkeypatch, n):
    mod = types.ModuleType("orz_tpu_torch.device.batch")
    mod.staged_segments = n
    monkeypatch.setitem(sys.modules, "orz_tpu_torch.device.batch", mod)
    assert _reader("staged_segments").read({}) == n


def test_readers_silent_without_the_counters(monkeypatch):
    """A program without the counters (the parent commit), one that has not
    run a batch yet, and one not loaded at all: None, no exception."""
    for name in ("orz_tpu_torch.device.pcontainer", "orz_tpu_torch.device.batch"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert _reader("pad_share").read({}) is None
    assert _reader("staged_segments").read({}) is None
    sys.modules["orz_tpu_torch.device.pcontainer"].batch_slots = 0
    sys.modules["orz_tpu_torch.device.pcontainer"].pad_slots = 0
    assert _reader("pad_share").read({}) is None
    for name in ("orz_tpu_torch.device.pcontainer", "orz_tpu_torch.device.batch"):
        monkeypatch.delitem(sys.modules, name)
    assert _reader("pad_share").read({}) is None
    assert _reader("staged_segments").read({}) is None
