"""Several processes: the process group and each process's share of the
input and the output.

Port of kit4b_tpu/parallel/distributed.py on `torch.distributed` where
JAX uses `jax.distributed`. The reference spreads work over machines by a
static partition and a filesystem merge (hammings -n/-N) and its own TCP
RPC (pacbiokit4b BKS); here every process runs the same program,
`initialize()` joins the group, `host_shard` gives each process its share
of the reads, and the per-process SAM files concatenate afterwards. One
process needs no group, so a program can call these helpers
unconditionally.
"""
from __future__ import annotations

import os


def _group():
    """The torch.distributed module when a process group exists, else
    None."""
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def _rank() -> int:
    g = _group()
    return g.get_rank() if g else 0


def _world() -> int:
    g = _group()
    return g.get_world_size() if g else 1


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               init_method: str | None = None) -> tuple[int, int]:
    """Joins `torch.distributed`'s process group from the arguments or
    torch's standard variables (MASTER_ADDR and MASTER_PORT for the
    coordinator, WORLD_SIZE, RANK); returns (process_id, process_count).

    coordinator is "host:port" (tcp://); init_method, where given, is used
    as it is (a file:// path needs no port). With one process and no
    coordinator it does nothing and returns (0, 1). If a group exists
    already, it returns that group's rank and size. The group is gloo's:
    the helpers below send no tensor, and NCCL would refuse two processes
    on one card."""
    import torch.distributed as dist
    if _group():
        return dist.get_rank(), dist.get_world_size()
    if coordinator is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    want_procs = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator or init_method or want_procs > 1:
        rank = process_id if process_id is not None \
            else int(os.environ.get("RANK", "0"))
        dist.init_process_group(
            "gloo", init_method=init_method or f"tcp://{coordinator}",
            world_size=want_procs, rank=rank)
    return _rank(), _world()


def host_shard(items, process_id: int | None = None,
               process_count: int | None = None):
    """Round-robin share of an iterable for this process: each process
    parses and aligns only its share of the reads, and the per-process SAM
    files concatenate afterwards."""
    pid = _rank() if process_id is None else process_id
    pcount = _world() if process_count is None else process_count
    for i, item in enumerate(items):
        if i % pcount == pid:
            yield item


def shard_output_path(path, process_id: int | None = None) -> str:
    """Per-process output naming: out.sam -> out.p3.sam on process 3; the
    path as it is for the only process."""
    pid = _rank() if process_id is None else process_id
    if pid == 0 and _world() == 1:
        return str(path)
    root, ext = os.path.splitext(str(path))
    return f"{root}.p{pid}{ext}"


def merge_sam_shards(out_path, shard_paths: list) -> None:
    """Concatenate per-process SAM files (the header from the first)."""
    with open(out_path, "w") as out:
        for i, p in enumerate(shard_paths):
            with open(p) as f:
                for line in f:
                    if line.startswith("@") and i > 0:
                        continue
                    out.write(line)


def global_mesh(axis_names=("dp", "tp"), shape=None, devices=None):
    """A mesh over this process's devices (default: every visible CUDA
    device; the port's processes do not share devices) in `shape`, which
    defaults to (all devices, 1)."""
    import numpy as np
    from .mesh import Mesh, default_devices
    devs = list(devices) if devices is not None else default_devices()
    if shape is None:
        shape = (len(devs), 1)
    n = shape[0] * shape[1]
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        arr[i] = d
    return Mesh(arr.reshape(*shape), axis_names)
