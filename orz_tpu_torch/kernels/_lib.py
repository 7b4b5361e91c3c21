"""Build and load the port's CUDA kernels (``orz_tpu_torch/csrc/*.cu``).

Each source compiles with its own nvcc process, all started together
(``-Xptxas=-v``: ``build_log`` keeps each kernel's registers and shared
memory), and the objects link into ONE shared library with a plain C
interface, keyed by a hash of the sources, under the repository's
``build/`` directory, at first use.  It is loaded with ctypes: every
pointer and the stream are ``c_void_p``, and every entry point returns
``cudaGetLastError()`` after its launch, which ``check`` turns into an
exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (pointers, ints, then the stream)
_SIGNATURES = {
    "otz_match_depth": [_P] * 8 + [_I] * 11 + [_P],
    "otz_match_depth_masked": [_P] * 9 + [_I] * 13 + [_P],
    "otz_fence_walk": [_P] * 4 + [_I] * 5 + [_P],
    "otz_symrank": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "otz_windowed_gather": [_P, _P, _P, _P, _I, _I, _P],
    "otz_seg_scan": [_P] * 4 + [_I] * 3 + [_P],
    "otz_seg_scan_values": [_P] * 4 + [_I] * 3 + [_P],
}

_lib = None
_lock = threading.Lock()
build_log: list[str] = []  # nvcc's output per source (ptxas -v), last build


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def build() -> str:
    """Compile the kernels (once per source hash); returns the .so path."""
    srcs = sources()
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    h.update(ARCH.encode())
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR,
                           f"liborz_tpu_torch_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so_path):
        nvcc = _nvcc()
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        objs = [os.path.join(_BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
                for s in srcs]
        procs = [subprocess.Popen(
            [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-Xptxas=-v",
             "-Xcompiler", "-fPIC", "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        failed = []
        build_log.clear()
        for src, proc in zip(srcs, procs):
            out, _ = proc.communicate()
            build_log.append(f"{os.path.basename(src)}:\n{out}")
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)}: {out}")
        tmp = f"{so_path}.tmp.{os.getpid()}"
        if not failed:
            res = subprocess.run([nvcc, "-shared", "-o", tmp] + objs,
                                 capture_output=True, text=True)
            if res.returncode != 0:
                failed.append(f"link: {res.stdout}{res.stderr}")
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, so_path)
    return so_path


def library():
    """The loaded kernel library (built on first call; no lock once
    loaded)."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def cuda_stream(name: str, *tensors) -> int:
    """Raise unless every tensor is a contiguous CUDA tensor on one device
    (the kernels take raw pointers and flat strides); return the raw
    pointer of that device's current stream, for the launch."""
    dev = tensors[0].get_device()  # -1 on the CPU
    for t in tensors:
        if dev < 0 or t.get_device() != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return torch.cuda.current_stream(dev).cuda_stream
