"""JAX's stream-parity digests: ``tests/torch_parity_digests.json``.

Each case's data is ``orz_tpu_torch.tools.parity_data.make_parity_data``'s
(numpy-free, so every machine draws the same bytes); JAX encodes it with
``orz_tpu.device.container.tpu_encode_bytes`` on XLA:CPU, batched (the
default) and staged (``ORZ_PER_SEGMENT=1``), and for ``S-l1`` also with
``orz_tpu.parallel.mesh.mesh_encode_segments`` over ``blocks_mesh(4)``
(its two segments twice over: one a device, ``parity_data.mesh_segments``).
For each case the file records the arguments, the schedule as
``otz2_schedule(level)`` returns it, the data's SHA-256 and, per path,
each segment payload's length and SHA-256, the ORZT stream's SHA-256 and
JAX's seconds.  The port's batched chain then runs the case on the CPU
(``encode_segments_batch(..., device="cpu")``): the file records its
seconds, whether its payloads equal JAX's, and how many of its items have
a reduced offset at or past ``FAR_RO_1`` and ``FAR_RO_2``.

    JAX_PLATFORMS=cpu python -m tests.torch_parity_ref [CASE ...]

runs the named cases (all by default, smallest first) and merges them into
the file.  Every ``OTZ*``/``ORZ*`` variable is cleared first; a staged
path sets ``ORZ_PER_SEGMENT=1`` for its own run only.  ``tests/
test_torch_parity_shape.py``, ``tests/test_torch_cuda.py`` and
``chip_smoke.py``'s ``jax parity`` phase hold the port to the file.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGESTS = os.path.join(ROOT, "tests", "torch_parity_digests.json")
KIB, MIB = 1 << 10, 1 << 20
SEED = 1

# name: (size, level, segments, segment_size, chunk_input, batch, paths)
CASES = {
    "S-l1": ("S", 1, 2, 128 * KIB, 32 * KIB, 2, ("batched", "staged", "mesh")),
    "S-l2": ("S", 2, 2, 128 * KIB, 32 * KIB, 2, ("batched", "staged")),
    "S-l3": ("S", 3, 2, 128 * KIB, 32 * KIB, 2, ("batched", "staged")),
    "L-l1": ("L", 1, 4, 1 * MIB, 256 * KIB, 4, ("batched", "staged")),
    "L-l2": ("L", 2, 4, 1 * MIB, 256 * KIB, 4, ("batched", "staged")),
    "XL-l1": ("XL", 1, 1, 8 * MIB, 2 * MIB, 1, ("batched", "staged")),
    # batched only: JAX's staged l2 at 8 MiB would take it past 45 minutes
    "XL-l2": ("XL", 2, 1, 8 * MIB, 2 * MIB, 1, ("batched",)),
}


def clear_knobs() -> None:
    for k in [k for k in os.environ if k.startswith(("OTZ", "ORZ"))]:
        del os.environ[k]


def case_data(name: str) -> bytes:
    from orz_tpu_torch.tools.parity_data import make_parity_data

    _, _, nseg, seg, *_ = CASES[name]
    return make_parity_data(SEED, nseg * seg, seg)


def jax_stream(name: str, path: str, data: bytes) -> bytes:
    """JAX's ORZT stream of the case (the mesh path's payloads framed as
    ``tpu_encode`` frames them)."""
    from orz_tpu.device.container import tpu_encode_bytes

    _, level, _, seg, chunk, batch, _ = CASES[name]
    if path == "mesh":
        from orz_tpu.parallel import blocks_mesh
        from orz_tpu.parallel.mesh import mesh_encode_segments
        from orz_tpu_torch.tools.parity_data import (MESH_DEVICES,
                                                     frame_stream,
                                                     mesh_segments)

        return frame_stream(mesh_encode_segments(
            mesh_segments(data, seg), level, chunk,
            mesh=blocks_mesh(MESH_DEVICES)), seg)
    if path == "staged":
        os.environ["ORZ_PER_SEGMENT"] = "1"
    try:
        return tpu_encode_bytes(data, level, segment_size=seg,
                                chunk_input=chunk, batch=batch)
    finally:
        os.environ.pop("ORZ_PER_SEGMENT", None)


def port_cpu_pass(name: str, data: bytes):
    """The port's batched chain on the CPU, batch by batch as
    ``torch_encode`` runs it: (payloads, its items' far counts)."""
    from orz_tpu_torch.device.host import _bucket_capacity
    from orz_tpu_torch.tools.parity_data import batch_far_counts

    _, level, _, seg, chunk, batch, _ = CASES[name]
    segs = [data[i:i + seg] for i in range(0, len(data), seg)]
    payloads, far = [], {"ro_ge_far_ro_1": 0, "ro_ge_far_ro_2": 0}
    for i in range(0, len(segs), batch):
        group = segs[i:i + batch]
        cap = min(_bucket_capacity(seg),
                  _bucket_capacity(max(len(s) for s in group)))
        got, counts = batch_far_counts(
            group + [group[0]] * (batch - len(group)), level, chunk, cap,
            device="cpu")
        payloads += got[:len(group)]
        far = {k: far[k] + counts[k] for k in far}
    return payloads, far


def run_case(name: str) -> dict:
    from orz_tpu.device.spec import otz2_schedule
    from orz_tpu_torch.tools.parity_data import stream_digests

    size, level, nseg, seg, chunk, batch, paths = CASES[name]
    data = case_data(name)
    rec = {"size": size, "level": level, "seed": SEED, "n": len(data),
           "segment_size": seg, "chunk_input": chunk, "batch": batch,
           "schedule": otz2_schedule(level),
           "data_sha256": hashlib.sha256(data).hexdigest(), "paths": {}}
    for path in paths:
        t0 = time.perf_counter()
        stream = jax_stream(name, path, data)
        rec["paths"][path] = dict(stream_digests(stream),
                                  jax_seconds=time.perf_counter() - t0)
        print(f"{name} {path}: {len(stream)} bytes, "
              f"{rec['paths'][path]['jax_seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    payloads, far = port_cpu_pass(name, data)
    rec["port_cpu"] = {
        "seconds": time.perf_counter() - t0,
        "batched_equal": [[len(p), hashlib.sha256(p).hexdigest()]
                          for p in payloads]
        == rec["paths"]["batched"]["segments"]}
    rec["far"] = far
    print(f"{name} port cpu: {rec['port_cpu']}, far {far}", flush=True)
    return rec


def main(argv: list[str]) -> int:
    clear_knobs()
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=4").strip()
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    names = argv or list(CASES)
    for name in names:
        rec = run_case(name)
        doc = {"generator": "tests/torch_parity_ref.py", "cases": {}}
        if os.path.exists(DIGESTS):
            with open(DIGESTS) as f:
                doc = json.load(f)
        doc["cases"][name] = rec
        doc["cases"] = {k: doc["cases"][k] for k in CASES
                        if k in doc["cases"]}
        with open(DIGESTS, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
