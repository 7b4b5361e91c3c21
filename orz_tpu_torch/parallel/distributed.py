"""Multi-process block-data-parallel compression on ``torch.distributed``:
``orz_tpu/parallel/distributed.py`` in torch.

The input is split into independent segments, striped round-robin across
processes (one process per GPU, or per CPU in the tests), each process
encodes its stripe, and the variable-length payloads are gathered in file
order: one ``all_gather`` of length-prefixed rows padded to the global
maximum, on the backend's device (NCCL on CUDA, gloo on the CPU).  Rank 0
writes the ORZT container.  A single process (world 1) needs no process
group and gathers nothing.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from orz_tpu_torch.device.batch import encode_segments_batch, resolve_device
from orz_tpu_torch.device.host import _bucket_capacity
from orz_tpu_torch.device.pipeline import encode_segment_staged
from orz_tpu_torch.ioutil import write_len
from orz_tpu_torch.pcontainer import TPU_MAGIC
from orz_tpu_torch.spec import CHUNK_INPUT_DEFAULT


def maybe_initialize(device: str | torch.device = "cuda",
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> bool:
    """Start the default process group if one is asked for: by
    `init_method` (e.g. ``tcp://127.0.0.1:<port>``; world_size and rank
    default to 1 and 0), or by torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  The backend is NCCL for a
    CUDA `device` and gloo for the CPU.  Returns whether a group is up;
    once one is asked for, a failed initialisation raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if init_method is None and not os.environ.get("MASTER_ADDR"):
        return False
    device = resolve_device(device, "maybe_initialize")
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init_method,
        world_size=1 if world_size is None else world_size,
        rank=0 if rank is None else rank)
    return True


def process_info() -> tuple[int, int]:
    """(rank, world size): (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def encode_striped(
    segments: List[bytes],
    level: int = 2,
    chunk_input: int = CHUNK_INPUT_DEFAULT,
    batch: int = 4,
    device: str | torch.device = "cuda",
) -> List[Optional[bytes]]:
    """Encode this process's stripe of `segments` (round-robin by index);
    other slots are None.  Runs of `batch` stripe segments go through the
    batched chain on their own bucket; a short run, or one that holds an
    empty segment, goes segment by segment through the staged encoder."""
    device = resolve_device(device, "encode_striped")
    rank, world = process_info()
    out: List[Optional[bytes]] = [None] * len(segments)
    mine = list(range(rank, len(segments), world))
    i = 0
    while i < len(mine):
        run = mine[i:i + batch]
        if len(run) == batch and all(len(segments[j]) > 0 for j in run):
            cap = _bucket_capacity(max(len(segments[j]) for j in run))
            payloads = encode_segments_batch(
                [segments[j] for j in run], level, chunk_input, cap=cap,
                device=device)
        else:
            payloads = [encode_segment_staged(segments[j], level,
                                              chunk_input, device=device)
                        for j in run]
        for j, p in zip(run, payloads):
            out[j] = p
        i += len(run)
    return out


def allgather_payloads(partial: List[Optional[bytes]]) -> List[bytes]:
    """Exchange stripes so that every process holds every payload, in
    order: a no-op at world 1."""
    import torch.distributed as dist

    rank, world = process_info()
    if world == 1:
        assert all(p is not None for p in partial)
        return list(partial)  # type: ignore[arg-type]
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    n = len(partial)
    maxlen = torch.tensor([max((len(p) for p in partial if p is not None),
                               default=0)], dtype=torch.int64, device=dev)
    dist.all_reduce(maxlen, op=dist.ReduceOp.MAX)
    buf = np.zeros((n, int(maxlen.item()) + 4), np.uint8)
    for i, p in enumerate(partial):
        if p is not None:
            buf[i, :4] = np.frombuffer(np.int32(len(p)).tobytes(), np.uint8)
            buf[i, 4:4 + len(p)] = np.frombuffer(p, np.uint8)
    rows = torch.from_numpy(buf).to(dev)
    gathered = [torch.empty_like(rows) for _ in range(world)]
    dist.all_gather(gathered, rows)
    out: List[bytes] = []
    for i in range(n):
        row = gathered[i % world][i].cpu().numpy()
        ln = int(np.frombuffer(row[:4].tobytes(), np.int32)[0])
        out.append(row[4:4 + ln].tobytes())
    return out


def distributed_encode_file(
    in_path: str,
    out_path: str,
    level: int = 2,
    segment_size: int = 1 << 23,
    chunk_input: int = CHUNK_INPUT_DEFAULT,
    device: str | torch.device = "cuda",
) -> None:
    """Encode a file across all processes into one ORZT container, which
    rank 0 writes; every rank reads the shared input."""
    device = resolve_device(device, "distributed_encode_file")
    rank, _ = process_info()
    segments = []
    with open(in_path, "rb") as f:
        while True:
            seg = f.read(segment_size)
            if not seg:
                break
            segments.append(seg)

    payloads = allgather_payloads(encode_striped(
        segments, level=level, chunk_input=chunk_input, device=device))
    if rank == 0:
        with open(out_path, "wb") as out:
            out.write(TPU_MAGIC)
            write_len(out, segment_size)
            for p in payloads:
                write_len(out, len(p))
                out.write(p)
            write_len(out, 0)
