"""Times the min-match kernel at every row width it is built for.

    python -m kit4b_tpu_torch.tools.time_minmm

For each Cw in 128, 256, ..., 768 (K up to 25, 51, ..., 153) it makes
seeded int8 rows in {-1, 0, 1} on the card (the time does not depend on
the values), launches the kernel once to build and warm it, then times two
launches with CUDA events on ROWS own rows against COLS partner columns,
sense with the diagonal inside, as the main path runs it. Each width is
printed with its bound: 2·ROWS·COLS·Cw int8 operations at 1,979 TOP/s, or
the bytes moved once at 3.35 TB/s where that is larger.

The shape fills the card: 131,072 own rows are 512 blocks of 256 rows, or
of 128 rows at Cw 768. To time another checkout's kernel at the same
shapes, run this file by its path with `PYTHONPATH` set to that
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


def time_widths(torch, minmm) -> list[dict]:
    """One dict per width: Cw, the two timed launches' ms, and the bound's
    ms and what sets it."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kw = dict(diag=True, span_lo=0, span_cnt=COLS // S, S=S, row_base=0)
    out = []
    for cw in WIDTHS:
        W = torch.randint(-1, 2, (COLS, cw), generator=gen, device=dev,
                          dtype=torch.int8)
        own = W[:ROWS]
        minmm(own, W, **kw)
        ms = [_time_ms(torch, lambda: minmm(own, W, **kw)) for _ in range(2)]
        ops_ms = 2 * ROWS * COLS * cw / INT8_PEAK * 1e3
        bytes_ms = (ROWS * cw + COLS * cw + 4 * ROWS) / HBM_RATE * 1e3
        out.append({"Cw": cw, "ms": ms, "bound_ms": max(ops_ms, bytes_ms),
                    "bound_by": "operations" if ops_ms >= bytes_ms
                    else "bytes"})
        del W, own
    return out


def main() -> int:
    import torch
    from kit4b_tpu_torch.kernels.minmm import minmm
    if not torch.cuda.is_available():
        print("time_minmm: CUDA is not available; this tool times the "
              "card's kernel", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    for row in time_widths(torch, minmm):
        share = row["bound_ms"] / (sum(row["ms"]) / 2)
        print(json.dumps({"rows": ROWS, "cols": COLS, **row,
                          "share_of_bound": share}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
