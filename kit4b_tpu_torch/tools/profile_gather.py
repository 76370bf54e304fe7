"""Times the hand gather kernel against its plain version on the card.

Port of tools/archive/profile_pallas_gather.py, with its shapes (an int32
table of 262,144 entries, 1 MB, and 524,288 int32 indices into it) and its
seeded inputs. Run from the root of a checkout on a machine with an NVIDIA
card:

    python -m kit4b_tpu_torch.tools.profile_gather

It prints the card, each version's mean time over 10 calls after a warm
call (CUDA events around host launches: at this size that is the host's
launch rate) and whether the two outputs match, and raises if they do not.
Then it prints each version's device time per call (`device_times`): the
sum of `torch.profiler`'s device time over LAUNCHES calls, and CUDA events
around one replay of a CUDA graph that holds LAUNCHES calls, which adds
the gap between graph nodes; and, by graph replay, the kernel's device
time at an eighth to four times the indices and at tables of 4 KB to 16 MB
(`scaling`), which separates a launch's fixed cost from the cost of a
random table read. It needs CUDA and has no CPU fallback.

To measure another checkout's kernel the same way, run this file by its
path with `PYTHONPATH` set to that checkout's root.
"""
from __future__ import annotations

import numpy as np
import torch

from kit4b_tpu_torch.device import resolve
from kit4b_tpu_torch.kernels.take import take, take_plain

T = 262_144          # table entries (1 MB of int32)
N = 524_288          # indices
CALLS = 10
LAUNCHES = 200       # calls of one device-time measurement


def inputs(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(table [T], idx [N]) int32 on `device`, drawn as the JAX tool draws
    them: numpy default_rng(0), the table first."""
    rng = np.random.default_rng(0)
    table = rng.integers(0, 2**31, T).astype(np.int32)
    idx = rng.integers(0, T, N).astype(np.int32)
    return torch.from_numpy(table).to(device), torch.from_numpy(idx).to(device)


def timeit(name: str, fn, *args) -> tuple[torch.Tensor, float]:
    """(output of a warm call, mean ms of CALLS more calls, CUDA events)."""
    out = fn(*args)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(CALLS):
        fn(*args)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / CALLS
    print(f"{name:40s} {ms:8.4f} ms  ({ms * 1e6 / N:.4f} ns/idx)",
          flush=True)
    return out, ms


def _profiler_us(fn, *args) -> float | None:
    """Device microseconds per call by `torch.profiler`: the device time of
    every kernel LAUNCHES calls ran, over LAUNCHES; None where the profiler
    saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LAUNCHES):
            fn(*args)
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / LAUNCHES if total > 0 else None


def _graph_us(fn, *args) -> float:
    """Device microseconds per call by CUDA events around the replay of a
    CUDA graph of LAUNCHES calls (the least of three replays)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(LAUNCHES):
            fn(*args)
    graph.replay()
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return min(ms) * 1e3 / LAUNCHES


def device_times(device: torch.device) -> dict[str, float | None]:
    """Device microseconds per call of the kernel and of the plain version
    at the profiler's shapes, each by `torch.profiler` (None where it shows
    no device time) and by a CUDA graph's replay."""
    table, idx = inputs(device)
    take(table, idx)
    take_plain(table, idx)
    return {"kernel_us": _profiler_us(take, table, idx),
            "kernel_graph_us": _graph_us(take, table, idx),
            "plain_us": _profiler_us(take_plain, table, idx),
            "plain_graph_us": _graph_us(take_plain, table, idx)}


def scaling(device: torch.device) -> list[dict[str, float]]:
    """The kernel's device microseconds per call (graph replay) at N / 8
    to 4 N indices into the profiler's table, and at N indices into tables
    of 1,024 to 4,194,304 entries."""
    rng = np.random.default_rng(1)
    shapes = [(T, n) for n in (N // 8, N // 4, N // 2, N, 2 * N, 4 * N)]
    shapes += [(t, N) for t in (1024, 16_384, 65_536, 1_048_576, 4_194_304)]
    rows = []
    for t, n in shapes:
        table = torch.from_numpy(
            rng.integers(0, 2**31, t).astype(np.int32)).to(device)
        idx = torch.from_numpy(rng.integers(0, t, n).astype(np.int32)).to(device)
        rows.append({"table": t, "indices": n,
                     "kernel_graph_us": _graph_us(take, table, idx)})
    return rows


def main() -> dict[str, float]:
    """Prints the profile; returns {"ms": kernel, "plain_ms": plain}."""
    dev = resolve("cuda")
    table, idx = inputs(dev)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    want, plain_ms = timeit("plain gather [524K] from [262K]", take_plain,
                            table, idx)
    got, kernel_ms = timeit("kernel take, table in L2", take, table, idx)
    match = torch.equal(got, want)
    print("match:", match, flush=True)
    if not match:
        raise AssertionError("the gather kernel differs from its plain "
                             "version")
    return {"ms": kernel_ms, "plain_ms": plain_ms}


if __name__ == "__main__":
    main()
    print("device time per call, us:", device_times(resolve("cuda")),
          flush=True)
    for row in scaling(resolve("cuda")):
        print(row, flush=True)
