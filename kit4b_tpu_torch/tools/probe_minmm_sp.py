"""Probes the 2:4-sparse int8 warpgroup product the min-match kernel runs on.

    python -m kit4b_tpu_torch.tools.probe_minmm_sp

Builds `csrc/sp_probe.cu` (which shares `csrc/wgmma_sp.cuh`, the
instruction wrappers and the 2:4 compression, with `csrc/minmm.cu`), then:

1. checks one warpgroup's product of a 64 x 128 2:4 A by an N x 128 B
   against a plain int64 product, for A from registers and from shared
   memory and N 128 and 256, on one-hot window rows made by
   `kmer.hammings_mxu.onehot_windows` from seeded codes (K 25) and on
   seeded rows of any two non-zeros a group; every `max_abs_err` must be 0;
2. times the kernel's consumer loop, without its producer: one block an SM
   of two consumer warpgroups, each walking TILES tiles of N partner
   columns x 128 channels that stay in shared memory, for each A source,
   N 128 and 256, with and without the fold of each tile into running row
   maxima. Each line gives the attainable share of the 2:4-sparse int8
   peak (3,958 TOP/s, counting the logical multiply-adds) and of the dense
   one (1,979 TOP/s).
"""
from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys

import numpy as np

SPARSE_PEAK = 3958e12    # H100 SXM 2:4-sparse int8 tensor operations per second
DENSE_PEAK = 1979e12     # H100 SXM dense int8 tensor operations per second
TILES = 20_000           # tiles a block of a timed loop
CHANNELS = 128           # channels (two sparse k-steps of 64) a tile


@functools.cache
def _lib() -> ctypes.CDLL:
    from kit4b_tpu_torch.kernels import build
    lib = build.load("sp_probe")
    lib.sp_probe_check.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_void_p] * 5
    lib.sp_probe_time.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    for fn in (lib.sp_probe_check, lib.sp_probe_time):
        fn.restype = ctypes.c_int
    return lib


def two_of_four_rows(rng: np.random.Generator, rows: int) -> np.ndarray:
    """[rows, 128] int8: in every aligned group of 4 channels two seeded
    positions hold seeded values in [-3, 3] (zeros included)."""
    out = np.zeros((rows, CHANNELS // 4, 4), np.int8)
    for r in range(rows):
        for g in range(CHANNELS // 4):
            pos = rng.choice(4, 2, replace=False)
            out[r, g, pos] = rng.integers(-3, 4, 2)
    return out.reshape(rows, CHANNELS)


def onehot_rows(torch, rng: np.random.Generator, rows: int) -> np.ndarray:
    """[rows, 128] int8 one-hot windows of K 25 from seeded codes with N
    bases and a separator."""
    from kit4b_tpu_torch.kmer.hammings_mxu import onehot_windows
    codes = rng.integers(0, 4, rows + 24).astype(np.uint8)
    codes[rng.integers(0, rows + 24, 6)] = 4
    codes[rows // 2] = 7
    W, _ = onehot_windows(torch.from_numpy(codes), 0, rows, K=25,
                          G=rows + 24)
    return W.numpy()


def check(torch, dev, seed: int = 0) -> list[dict]:
    """One dict per (A source, N, input): the largest absolute difference
    from the plain product and the 2:4 faults the compression counted."""
    rng = np.random.default_rng(seed)
    out = []
    for label, a in (("onehot", onehot_rows(torch, rng, 64)),
                     ("two_of_four", two_of_four_rows(rng, 64))):
        for n in (128, 256):
            b = rng.integers(-2, 3, (n, CHANNELS)).astype(np.int8)
            want = a.astype(np.int64) @ b.astype(np.int64).T
            for rs in (1, 0):
                ta, tb = (torch.from_numpy(x).to(dev) for x in (a, b))
                d = torch.zeros((64, n), dtype=torch.int32, device=dev)
                bad = torch.zeros(1, dtype=torch.int32, device=dev)
                err = _lib().sp_probe_check(
                    dev.index or 0, rs, n, ta.data_ptr(), tb.data_ptr(),
                    d.data_ptr(), bad.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"sp_probe_check: CUDA error {err}")
                torch.cuda.synchronize(dev)
                got = d.cpu().numpy().astype(np.int64)
                out.append({"input": label, "A": "registers" if rs else "smem",
                            "N": n, "max_abs_err": int(np.abs(got - want).max()),
                            "faults": int(bad.item())})
    return out


def time_loops(torch, dev, tiles: int = TILES) -> list[dict]:
    """One dict per (A source, N, fold): ms of the loop by CUDA events
    (least of two launches after a warm one) and its shares of the peaks."""
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = []
    for rs in (1, 0):
        for n in (128, 256):
            for epi in (0, 1):
                def launch(t=tiles):
                    err = _lib().sp_probe_time(dev.index or 0, rs, n, epi, t,
                                               blocks, sink.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"sp_probe_time: CUDA error {err}")
                launch(100)
                ms = []
                for _ in range(2):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    launch()
                    b.record()
                    b.synchronize()
                    ms.append(a.elapsed_time(b))
                rows = 256 if n == 128 else 128     # own rows a block
                ops = 2 * blocks * tiles * rows * n * CHANNELS
                best = min(ms)
                out.append({"A": "registers" if rs else "smem", "N": n,
                            "fold": bool(epi), "ms": ms,
                            "sparse_share": ops / (best * 1e-3) / SPARSE_PEAK,
                            "dense_share": ops / (best * 1e-3) / DENSE_PEAK})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_minmm_sp: CUDA is not available; this tool probes the "
              "card's tensor cores", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    rows = check(torch, dev)
    for row in rows:
        print(json.dumps(row))
    if any(r["max_abs_err"] or r["faults"] for r in rows):
        print("probe_minmm_sp: the sparse product differs from the plain one",
              file=sys.stderr)
        return 1
    for row in time_loops(torch, dev):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
