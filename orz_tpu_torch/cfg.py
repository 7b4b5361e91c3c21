"""Compression configuration of the host ORZ codec (reference src/lz.rs:32-47,
src/main.rs:97-101), copied for the port from ``orz_tpu/cfg.py``."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LZCfg:
    """Lempel-Ziv matching options.

    match_depth:       hash-chain walk depth for the main match search
    lazy_match_depth1: probe depth for the lazy match at pos+1
    lazy_match_depth2: probe depth for the lazy match at pos+2
    """

    match_depth: int = 45
    lazy_match_depth1: int = 27
    lazy_match_depth2: int = 18


# Level presets (reference src/main.rs:97-101)
LEVEL_PRESETS = {
    0: LZCfg(5, 3, 2),
    1: LZCfg(15, 9, 6),
    2: LZCfg(45, 27, 18),
    # level 3 is an OTZ-engine quality preset (a deeper masked-iteration
    # schedule, device/spec.py otz2_schedule); the host ORZ codec has no
    # deeper search than the reference's l2, so it maps to the same cfg
    3: LZCfg(45, 27, 18),
}


def cfg_from_level(level: int) -> LZCfg:
    try:
        return LEVEL_PRESETS[level]
    except KeyError:
        raise ValueError(f"invalid level: {level}") from None
