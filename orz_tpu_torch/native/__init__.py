"""Native C++ codec backend: builds csrc/orz_core.cpp on demand and binds it
via ctypes; copied for the port from ``orz_tpu/native/__init__.py``.

The native codec implements the chunk-level L1-L3 layers; the container layer
(orz_tpu_torch/container.py) stays in Python and owns the window buffer,
exactly mirroring the reference's lib.rs/lz.rs split.  The source is the
JAX package's, at the repository root, built with the same flags into the
same ``build/liborz_core_<digest>.so``, so both packages load one file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from orz_tpu_torch.cfg import LZCfg
from orz_tpu_torch.constants import LZ_TBUF_CAPACITY

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "csrc", "orz_core.cpp")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build")

_lib = None
_lib_lock = threading.Lock()


class _CfgStruct(ctypes.Structure):
    _fields_ = [
        ("match_depth", ctypes.c_int32),
        ("lazy_match_depth1", ctypes.c_int32),
        ("lazy_match_depth2", ctypes.c_int32),
    ]


def build_library(src: str, stem: str) -> str:
    """Build the C++ source `src` with g++ into build/<stem>_<digest>.so
    unless that file exists; returns its path.  The port's OTZ decoder
    (``device/container.py``, ``csrc/otz_core.cpp``) builds through it
    too, with the same flags as the JAX package's loaders."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"{stem}_{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp.{os.getpid()}"
        cmd = [
            "g++", "-O3", "-std=c++17", "-fPIC", "-shared",
            "-fno-exceptions", "-funroll-loops",
            src, "-o", tmp,
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    return so_path


def _build_library() -> str:
    return build_library(_SRC, "liborz_core")


def get_library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(_build_library())
            lib.orz_enc_new.restype = ctypes.c_void_p
            lib.orz_enc_new.argtypes = [ctypes.POINTER(_CfgStruct)]
            lib.orz_enc_free.argtypes = [ctypes.c_void_p]
            lib.orz_enc_forward.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.orz_enc_chunk.restype = ctypes.c_int64
            lib.orz_enc_chunk.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ]
            lib.orz_dec_new.restype = ctypes.c_void_p
            lib.orz_dec_new.argtypes = []
            lib.orz_dec_free.argtypes = [ctypes.c_void_p]
            lib.orz_dec_forward.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.orz_dec_chunk.restype = ctypes.c_int64
            lib.orz_dec_chunk.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ]
            _lib = lib
    return _lib


def _addr(arr: np.ndarray) -> int:
    return arr.ctypes.data


class NativeEncoder:
    def __init__(self, cfg: LZCfg):
        self.lib = get_library()
        c = _CfgStruct(cfg.match_depth, cfg.lazy_match_depth1, cfg.lazy_match_depth2)
        self.handle = self.lib.orz_enc_new(ctypes.byref(c))
        if not self.handle:
            raise MemoryError("orz_enc_new failed")
        self.tbuf = np.empty(LZ_TBUF_CAPACITY, dtype=np.uint8)

    def encode_chunk(self, sbuf: np.ndarray, sbuf_len: int, spos: int):
        assert sbuf.dtype == np.uint8 and sbuf.flags.c_contiguous
        tlen = ctypes.c_int64(0)
        new_spos = self.lib.orz_enc_chunk(
            self.handle, _addr(sbuf), sbuf_len, spos,
            _addr(self.tbuf), self.tbuf.size, ctypes.byref(tlen),
        )
        if new_spos < 0:
            raise RuntimeError(f"native encode failed: {new_spos}")
        return int(new_spos), self.tbuf[: tlen.value].tobytes()

    def forward(self, n: int) -> None:
        self.lib.orz_enc_forward(self.handle, n)

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.orz_enc_free(self.handle)
            self.handle = None


class NativeDecoder:
    def __init__(self):
        self.lib = get_library()
        self.handle = self.lib.orz_dec_new()
        if not self.handle:
            raise MemoryError("orz_dec_new failed")

    def decode_chunk(self, tbuf: bytes, sbuf: np.ndarray, sbuf_cap: int, spos: int) -> int:
        assert sbuf.dtype == np.uint8 and sbuf.flags.c_contiguous
        t = np.frombuffer(tbuf, dtype=np.uint8)
        new_spos = self.lib.orz_dec_chunk(self.handle, _addr(t), t.size, _addr(sbuf), sbuf_cap, spos)
        if new_spos < 0:
            raise ValueError(f"invalid ORZ stream (native decoder error {new_spos})")
        return int(new_spos)

    def forward(self, n: int) -> None:
        self.lib.orz_dec_forward(self.handle, n)

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.orz_dec_free(self.handle)
            self.handle = None


class NativeBackend:
    """Container backend over the native C++ codec."""

    def __init__(self):
        get_library()  # build eagerly so failures surface here

    @staticmethod
    def new_encoder(cfg: LZCfg):
        return NativeEncoder(cfg)

    @staticmethod
    def new_decoder():
        return NativeDecoder()
