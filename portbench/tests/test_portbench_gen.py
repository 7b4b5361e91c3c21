"""The traffic generators give the same bytes on every machine."""

import json
import os

import pytest

import tiny  # noqa: F401  (puts portbench/ on sys.path)

pytest.importorskip("numpy")
from harness import Cell, load_module  # noqa: E402

GEN = os.path.join(tiny.PB, "gen")

# digests of the tiny parameter sets, pinned: the same seed must give the
# same bytes under any numpy, any Python 3.12 and any machine
PINNED = {
    ("enwik8", 2 ** 31 + 5): "344a2d5c9c80f8b4",
    ("canterbury", 2 ** 31 + 5): "5c1a75aa99ccf193",
}


def gen(name):
    return load_module(os.path.join(GEN, name + ".py"), "portbench_gen_" + name)


@pytest.mark.parametrize("name,params", [("enwik8", tiny.TINY_ENWIK8),
                                         ("canterbury", tiny.TINY_CANTERBURY)])
def test_seed_gives_same_bytes(name, params):
    g = gen(name)
    a, b, c = g.make(2 ** 31 + 5, params), g.make(2 ** 31 + 5, params), g.make(6, params)
    assert a.digest() == b.digest() != c.digest()
    assert [a.item(i) for i in range(3)] == [b.item(i) for i in range(3)]
    assert a.item(0) != c.item(0)
    want = PINNED[(name, 2 ** 31 + 5)]
    assert a.digest() == want


def test_enwik8_files():
    g = gen("enwik8")
    s = g.make(9, tiny.TINY_ENWIK8)
    files = [s.item(i) for i in range(4)]
    assert all(len(f) == tiny.TINY_ENWIK8["file_bytes"] for f in files)
    assert len(set(files)) == 4
    seg = 4096
    segs = [f[k:k + seg] for f in files for k in range(0, len(f), seg)]
    assert len(set(segs)) == len(segs)  # no two segments byte-identical


def test_pool_within_48_mib():
    with open(os.path.join(tiny.PB, "traffic", "enwik8-files.json")) as f:
        p = json.load(f)["params"]
    assert p["pool_bytes"] <= 48 << 20
    assert p["file_bytes"] == 10 ** 8


# the Canterbury corpus's files (Arnold and Bell 1997): name, bytes, kind
CANTERBURY = [
    ("alice29.txt", 152089, "text"), ("asyoulik.txt", 125179, "text"),
    ("cp.html", 24603, "html"), ("fields.c", 11150, "c"),
    ("grammar.lsp", 3721, "lisp"), ("kennedy.xls", 1029744, "xls"),
    ("lcet10.txt", 426754, "text"), ("plrabn12.txt", 481861, "text"),
    ("ptt5", 513216, "fax"), ("sum", 38240, "exe"), ("xargs.1", 4227, "man"),
]


def test_canterbury_objects_are_the_corpus_files():
    g = gen("canterbury")
    with open(os.path.join(tiny.PB, "traffic", "canterbury-objects.json")) as f:
        p = json.load(f)["params"]
    assert [tuple(o) for o in p["objects"]] == CANTERBURY
    s = g.make(3, tiny.TINY_CANTERBURY)
    assert [len(o) for o in s.objects] == [n for _, n, _ in tiny.TINY_CANTERBURY["objects"]]
    assert s.sizes() == [n for _, n, _ in tiny.TINY_CANTERBURY["objects"]]
    # every pass replays every object once, in its own order
    n = s.pass_len
    assert sorted(s.order(0)) == list(range(n)) and s.order(0) != s.order(1)
    with pytest.raises(ValueError):
        g.make(3, dict(objects=[["z", 100, "poem"]], vocabulary=50))


def test_cell_sources_resolve():
    for cell in ("l2-enwik8", "l2-canterbury"):
        c = Cell(cell)
        assert c.traffic["generator"] in ("enwik8", "canterbury")
