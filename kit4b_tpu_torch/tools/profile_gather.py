"""Times the hand gather kernel against its plain version on the card.

Port of tools/archive/profile_pallas_gather.py, with its shapes (an int32
table of 262,144 entries, 1 MB, and 524,288 int32 indices into it) and its
seeded inputs. Run from the root of a checkout on a machine with an NVIDIA
card:

    python -m kit4b_tpu_torch.tools.profile_gather

It prints the card, each version's mean time over 10 calls after a warm
call (CUDA events) and whether the two outputs match, and raises if they do
not. It needs CUDA and has no CPU fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..kernels.take import take, take_plain

T = 262_144          # table entries (1 MB of int32)
N = 524_288          # indices
CALLS = 10


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
