"""Times the min-match kernel at every row width it is built for.

    python -m kit4b_tpu_torch.tools.time_minmm

For each Cw in 128, 256, ..., 768 (K 25, 51, 76, 102, 128, 153, the
widest K of each) it builds one-hot window rows with
`kmer.hammings_mxu.onehot_windows` from seeded codes on the card (the
kernel takes 2:4-sparse own rows, which one-hot windows are; the time does
not depend on the values), launches the kernel once to build and warm it,
then times two launches with CUDA events on ROWS own rows against COLS
partner columns, sense with the diagonal inside, as the main path runs it.
Each width is printed with two bounds: `bound_ms`, the 2:4-sparse one the
kernel runs at, 2·ROWS·COLS·64·⌈5K/64⌉ int8 operations at 3,958 TOP/s,
and `dense_bound_ms`, every one of the Cw channels at the dense 1,979
TOP/s, each the bytes moved once at 3.35 TB/s where that is larger.

The shape fills the card: 131,072 own rows are 256 blocks of 512 rows at
Cw 128, 1,024 blocks of 128 wider. To time another checkout's kernel at
the same shapes, run this file by its path with `PYTHONPATH` set to that
checkout's root; the wrapper contract (`kernels/minmm.py`) is the same.
"""
from __future__ import annotations

import json
import subprocess
import sys

S = 1024                  # partner columns per span, the engine's default
WIDTHS = (128, 256, 384, 512, 640, 768)
ROWS, COLS = 131_072, 262_144   # COLS >= ROWS: own rows are W[:ROWS]
INT8_PEAK = 1979e12       # H100 SXM dense int8 tensor operations per second
SPARSE_PEAK = 3958e12     # the same with 2:4 structured sparsity
SPARSE_K_STEP = 64        # int8 reduction of one sparse wgmma step
HBM_RATE = 3.35e12        # H100 SXM device memory bytes per second


def _time_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def bounds_ms(rows: int, cols: int, K: int) -> tuple[float, float]:
    """(2:4-sparse, dense) bound in ms of one launch of `rows` own rows of
    K-mer one-hots against `cols` partner columns: the operations at the
    rate, or the bytes once, the larger."""
    cw = -(-5 * K // 128) * 128
    sparse_ch = -(-5 * K // SPARSE_K_STEP) * SPARSE_K_STEP
    bytes_ms = (rows * cw + cols * cw + 4 * rows) / HBM_RATE * 1e3
    return (max(2 * rows * cols * sparse_ch / SPARSE_PEAK * 1e3, bytes_ms),
            max(2 * rows * cols * cw / INT8_PEAK * 1e3, bytes_ms))


def time_widths(torch, minmm, onehot_windows, check_faults) -> list[dict]:
    """One dict per width: Cw, K, the two timed launches' ms, and both
    bounds' ms."""
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kw = dict(diag=True, span_lo=0, span_cnt=COLS // S, S=S, row_base=0)
    out = []
    for cw in WIDTHS:
        K = cw // 5
        codes = torch.randint(0, 4, (COLS + K - 1,), generator=gen,
                              device=dev, dtype=torch.uint8)
        W, _ = onehot_windows(codes, 0, COLS, K=K, G=COLS + K - 1)
        own = W[:ROWS]
        minmm(own, W, **kw)
        ms = [_time_ms(torch, lambda: minmm(own, W, **kw)) for _ in range(2)]
        check_faults(dev)
        sparse_ms, dense_ms = bounds_ms(ROWS, COLS, K)
        out.append({"Cw": cw, "K": K, "ms": ms, "bound_ms": sparse_ms,
                    "dense_bound_ms": dense_ms})
        del W, own, codes
    return out


def main() -> int:
    import torch
    from kit4b_tpu_torch.kernels import minmm as mod
    from kit4b_tpu_torch.kmer.hammings_mxu import onehot_windows
    # a checkout from before the 2:4-sparse kernel keeps no fault count
    check_faults = getattr(mod, "check_faults", lambda device: None)
    if not torch.cuda.is_available():
        print("time_minmm: CUDA is not available; this tool times the "
              "card's kernel", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    for row in time_widths(torch, mod.minmm, onehot_windows, check_faults):
        mean = sum(row["ms"]) / 2
        print(json.dumps({"rows": ROWS, "cols": COLS, **row,
                          "share_of_bound": row["bound_ms"] / mean,
                          "share_of_dense_bound":
                              row["dense_bound_ms"] / mean}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
