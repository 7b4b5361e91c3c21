"""Random numbers that are the same on every machine.

numpy's ``Generator`` methods may draw other values under another numpy
release, and float functions may round differently under other SIMD
code.  Everything here is integer arithmetic: a splitmix64 counter
stream (Steele, Lea and Flood, "Fast splittable pseudorandom number
generators", OOPSLA 2014) evaluated with wrapping uint64 numpy
operations, and ``random.Random`` for the few draws made in Python loops
(its ``randrange`` and ``random`` are fixed across Python releases).
"""

from __future__ import annotations

import random

import numpy as np

M64 = (1 << 64) - 1
GAMMA = 0x9E3779B97F4A7C15


def _mix(z: int) -> int:
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return z ^ (z >> 31)


def key(*path: int) -> int:
    """A 64-bit stream key from a seed and stream numbers."""
    k = 0
    for p in path:
        k = _mix((k + GAMMA + (p & M64)) & M64)
    return k


def u64(k: int, n: int, start: int = 0) -> np.ndarray:
    """Values start .. start+n-1 of stream `k`, uint64."""
    z = (np.arange(start, start + n, dtype=np.uint64) * np.uint64(GAMMA)
         + np.uint64(k))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def below(k: int, n: int, m: int) -> np.ndarray:
    """n integers in [0, m), int64 (m < 2**62)."""
    return ((u64(k, n) >> np.uint64(1)) % np.uint64(m)).astype(np.int64)


def weighted(k: int, n: int, weights) -> np.ndarray:
    """n indices drawn with the given integer weights."""
    cum = np.cumsum(np.asarray(weights, dtype=np.int64))
    return np.searchsorted(cum, below(k, n, int(cum[-1])), side="right")


def zipf_weights(n: int, q: int = 27) -> np.ndarray:
    """Zipf-Mandelbrot weights 1/(rank + q/10), as integers."""
    return (10 ** 13) // (10 * np.arange(n, dtype=np.int64) + q)


def py(k: int) -> random.Random:
    """A Python generator for loops of a few thousand draws."""
    return random.Random(k)


def field(z: np.ndarray, lo: int, bits: int) -> np.ndarray:
    """Bits [lo, lo + bits) of each uint64, as uint64."""
    return (z >> np.uint64(lo)) & np.uint64((1 << bits) - 1)


def scaled(f: np.ndarray, bits: int, m: int) -> np.ndarray:
    """A `bits`-bit field mapped onto [0, m), int64 (m << bits < 2**64)."""
    return ((f * np.uint64(m)) >> np.uint64(bits)).astype(np.int64)


def pick(f: np.ndarray, bits: int, weights) -> np.ndarray:
    """A `bits`-bit field mapped onto indices drawn with integer weights
    (through a table of all 2**bits field values)."""
    cum = np.cumsum(np.asarray(weights, dtype=np.int64))
    grid = np.arange(1 << bits, dtype=np.uint64)
    lut = np.searchsorted(cum, scaled(grid, bits, int(cum[-1])), side="right")
    return lut.astype(np.int32)[f.astype(np.int64)]
