"""The stream-parity data: bytes that every numpy and every machine draw alike.

``make_parity_data(seed, n, segment)`` builds `n` bytes from Python's
``random.Random(seed)`` (the Mersenne Twister, whose draws from an int seed
do not change between Python versions; numpy's generators do change between
numpy versions, so none is used).  Each `segment`-byte segment is 64 KiB
spans, as ``chip_smoke.py``'s data is: text-like spans (words from a fixed
vocabulary, Zipf-like pick), binary-like spans (runs, noise, repeats) and
long-range repeats of earlier spans, with one far block in the middle:

- a text anchor, then two halves of random bytes over two values
  (``b" "``, ``b"."``), each half followed by a copy of the anchor's tail.
  Both stretch bytes are non-alphanumeric, so every stretch position after
  a space is in the byte context ``0x20``, the context of a word that
  follows ``", "`` or ``". "`` in text.  Half of a stretch's positions are
  in that context, and no stretch dword is a text dword, so a copied
  word's candidates lie in the text before the stretch: a rare word's is
  in the anchor, one half (for the second copy, two halves) of that
  context back;
- a half is ``FAR_HALF`` bytes (``FAR_HALF_SMALL`` in a segment under
  1 MiB): the context then recurs more than ``FAR_RO_2`` (16382) times in
  a small segment, where the first copy's anchor lies past ``FAR_RO_1``
  and the second's past ``FAR_RO_2``, and more than ``RING`` (32766)
  times from 1 MiB, where the first copy's anchor lies between
  ``FAR_RO_2`` and ``RING`` and the second's past the ring (it matches
  the first copy).

``batch_far_counts`` runs ``encode_segments_batch`` and counts its items'
reduced offsets at or past the two far gates; ``stream_digests`` and
``parity_faults`` hold an ORZT stream to the digests that
``tests/torch_parity_ref.py`` records (``frame_stream`` and
``stream_payloads`` frame and split one).
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import random

import numpy as np

from orz_tpu_torch.spec import FAR_RO_1, FAR_RO_2, ROID_DEC

SPAN = 1 << 16
FAR_HALF = 40 << 10  # about 20 Ki positions of the context a half
FAR_HALF_SMALL = 20 << 10  # about 10 Ki
ANCHOR = 16 << 10
ANCHOR_COPY = 2 << 10
STRETCH_VALUES = b" ."

_LETTERS = b"etaoinshrdlcumwfgypbvkjxqz"
_SEPS = [b" ", b" ", b" ", b"\n", b", ", b". "]


def _vocab(rng: random.Random) -> list[bytes]:
    vocab = [bytes(rng.choices(_LETTERS, k=rng.randint(2, 10)))
             for _ in range(3000)]
    return vocab + [b"the", b"of", b"and", b"0123456789", b"(x)", b"[i]"]


def _zipf_cum(k: int, s: float = 1.25) -> list[float]:
    return list(itertools.accumulate(1.0 / (i + 1) ** s for i in range(k)))


def text_span(rng: random.Random, vocab: list[bytes], cum: list[float],
              n: int = SPAN) -> bytes:
    """Words picked with Zipf-like weights, each with a separator."""
    out, size = [], 0
    total = cum[-1]
    while size < n:
        w = vocab[bisect.bisect_right(cum, rng.random() * total)]
        piece = w + _SEPS[rng.randrange(len(_SEPS))]
        out.append(piece)
        size += len(piece)
    return b"".join(out)[:n]


def binary_span(rng: random.Random, n: int = SPAN) -> bytes:
    """Runs, random bytes and repeated blocks."""
    out = bytearray()
    while len(out) < n:
        c = rng.random()
        if c < 0.3:
            out += bytes([rng.randrange(256)]) * rng.randint(1, 63)
        elif c < 0.6:
            out += rng.randbytes(rng.randint(1, 127))
        else:
            take = min(len(out), rng.randint(4, 255))
            out += out[len(out) - take:]
    return bytes(out[:n])


def stretch(rng: random.Random, n: int) -> bytes:
    """n random bytes over STRETCH_VALUES."""
    return bytes(rng.choices(STRETCH_VALUES, k=n))


def far_block(rng: random.Random, vocab, cum, half: int) -> bytes:
    """A text anchor, then two stretch halves, each followed by a copy of
    the anchor's tail."""
    anchor = text_span(rng, vocab, cum, ANCHOR)
    tail = anchor[-ANCHOR_COPY:]
    return b"".join((anchor, stretch(rng, half), tail, stretch(rng, half),
                     tail))


def make_parity_data(seed: int, n: int, segment: int = 1 << 17) -> bytes:
    """n bytes: each `segment`-byte segment is 64 KiB spans (60% text, 40%
    binary, 5% of them repeats of an earlier span of the same segment),
    with the far block placed after its first half."""
    rng = random.Random(seed)
    vocab = _vocab(rng)
    cum = _zipf_cum(len(vocab))
    half = FAR_HALF if segment >= 1 << 20 else FAR_HALF_SMALL
    out = []
    for _ in range(-(-n // segment)):
        spans: list[bytes] = []
        size = 0
        placed = False
        while size < segment:
            if not placed and size >= segment // 2:
                spans.append(far_block(rng, vocab, cum, half))
                placed = True
            elif spans and rng.random() < 0.05:
                spans.append(spans[rng.randrange(len(spans))])
            elif rng.random() < 0.6:
                spans.append(text_span(rng, vocab, cum))
            else:
                spans.append(binary_span(rng))
            size += len(spans[-1])
        out.append(b"".join(spans)[:segment])
    return b"".join(out)[:n]


def far_counts(ro: np.ndarray) -> dict[str, int]:
    """Reduced offsets at or past FAR_RO_1 and FAR_RO_2."""
    ro = np.asarray(ro)
    return {"ro_ge_far_ro_1": int((ro >= FAR_RO_1).sum()),
            "ro_ge_far_ro_2": int((ro >= FAR_RO_2).sum())}


def item_reduced_offsets(symbol: np.ndarray, robits: np.ndarray,
                         valid: np.ndarray) -> np.ndarray:
    """The reduced offsets of the ROLZ matches among items (their symbol
    256 + roid * LZ_LENID_SIZE + lenid, below REP0_BASE; robits the offset
    past the roid's base)."""
    from orz_tpu_torch.spec import LZ_LENID_SIZE, REP0_BASE

    symbol = np.asarray(symbol)
    match = valid & (symbol >= 256) & (symbol < REP0_BASE)
    roid = (symbol[match] - 256) // LZ_LENID_SIZE
    return ROID_DEC[roid, 0].astype(np.int64) + np.asarray(robits)[match]


MESH_DEVICES = 4


def mesh_segments(data: bytes, segment: int) -> list[bytes]:
    """The segments of `data`, repeated from the first up to a multiple of
    MESH_DEVICES (the mesh takes a batch that its devices divide)."""
    segs = [data[i:i + segment] for i in range(0, len(data), segment)]
    return (segs * MESH_DEVICES)[:-(-len(segs) // MESH_DEVICES)
                                 * MESH_DEVICES]


def batch_far_counts(segs: list[bytes], level: int, chunk_input: int,
                     cap: int, device="cuda"):
    """``encode_segments_batch`` of `segs` at one bucket: (the payloads,
    ``far_counts`` of its items' reduced offsets, read at MID or MID2)."""
    import torch

    from orz_tpu_torch.device.batch import encode_segments_batch

    ros = []

    def stage(name, fn):
        out = fn()
        if name in ("MID", "MID2"):
            items = out[0]
            slots = torch.arange(items.kind.shape[1],
                                 device=items.kind.device)
            valid = (slots < items.n_items[:, None]).cpu().numpy()
            ros.append(item_reduced_offsets(items.symbol.cpu().numpy(),
                                            items.robits.cpu().numpy(), valid))
        return out

    payloads = encode_segments_batch(segs, level, chunk_input, cap=cap,
                                     device=device, stage=stage)
    return payloads, far_counts(np.concatenate(ros) if ros else [])


# --- ORZT streams and their digests -------------------------------------------


def frame_stream(payloads: list[bytes], segment_size: int) -> bytes:
    """The ORZT stream framing `payloads` (``pcontainer``'s wire format)."""
    from orz_tpu_torch.ioutil import encode_len_bytes
    from orz_tpu_torch.pcontainer import TPU_MAGIC

    return b"".join([TPU_MAGIC, encode_len_bytes(segment_size)]
                    + [encode_len_bytes(len(p)) + p for p in payloads]
                    + [encode_len_bytes(0)])


def stream_payloads(stream: bytes) -> list[bytes]:
    """The segment payloads of an ORZT stream, in order."""
    import io

    from orz_tpu_torch.ioutil import read_len
    from orz_tpu_torch.pcontainer import MAGIC_LEN, TPU_MAGIC

    src = io.BytesIO(stream)
    if src.read(MAGIC_LEN) != TPU_MAGIC:
        raise ValueError("not an ORZT stream")
    read_len(src)  # segment size
    out = []
    while n := read_len(src):
        out.append(src.read(n))
    if src.read(1):
        raise ValueError("bytes after the ORZT end mark")
    return out


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def stream_digests(stream: bytes) -> dict:
    """Each payload's [length, SHA-256] and the stream's SHA-256."""
    return {"segments": [[len(p), sha256(p)] for p in stream_payloads(stream)],
            "stream_sha256": sha256(stream)}


def parity_faults(rec: dict, path: str, data: bytes,
                  stream: bytes) -> list[str]:
    """How `stream`, the port's encode of `data` on `path`, differs from
    the digest record `rec` of one case (empty: equal)."""
    if sha256(data) != rec["data_sha256"]:
        return ["data differs"]
    want = rec["paths"][path]
    got = stream_digests(stream)
    faults = [f"segment {i}: payload differs ({g[0]} bytes, JAX {w[0]})"
              for i, (g, w) in enumerate(zip(got["segments"],
                                             want["segments"])) if g != w]
    if len(got["segments"]) != len(want["segments"]):
        faults.append(f"{len(got['segments'])} segments, JAX "
                      f"{len(want['segments'])}")
    if not faults and got["stream_sha256"] != want["stream_sha256"]:
        faults.append("framing differs")
    return faults
