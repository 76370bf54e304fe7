"""Times the offset-sweep kernel on slices of a chromosome-length sweep.

    python -m kit4b_tpu_torch.tools.time_sweep

On a seeded random genome of S. cerevisiae R64 chromosome IV's length
(1,531,933 bp + EOG, with N runs) it launches the kernel on the first
SLICE offsets of the sense sweep (own = partner = the genome, d >= 1) and
of the antisense sweep (partner = the reverse complement, d >= 0) at K 7,
13 and 25: once to build and warm it, then REPS times timed with CUDA
events.
Each row is printed with three floors for its window pairs:

- `tensor_ms`, the bound that does not depend on the method: the card's
  fastest unit for counting matches over window pairs is the int8 tensor
  core, reckoned as the min-match kernel's bound is (a pair is a product
  of two one-hot rows of 5 K columns, padded to the 32-byte depth of a
  tensor-core step: 256 operations at K = 25, at 1,979 TOP/s). The padding
  is the unit's, not the function's: `tensor_exact_ms` charges the 2 x 5 K
  operations the function needs and no more, and is the bound to hold a
  K under 25 to (70 and 130 operations against the padded 128 and 192 at
  K 7 and 13);
- `popc_ms`, the floor of the one-popcount-a-pair method the kernel used
  before (16 popcounts a clock on each of 132 SMs at 1.98 GHz);
- `sliced_ms`, the floor of the bit-sliced method `csrc/sweep.cu` uses now:
  `ops_per_step` shifts and three-input gates for the 32 x LANE_WORDS
  pairs of a lane's step, at 64 integer lanes a clock on each SM.

To time another checkout's kernel on the same slices, run this file by its
path with `PYTHONPATH` set to that checkout's root; the wrapper contract
(`kernels/sweep.py`) is the same.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np

CHR4_LEN = 1_531_933      # S. cerevisiae R64 chromosome IV
SLICE = 4096              # offsets of a timed slice
KS = (7, 13, 25)
REPS = 5                  # timed launches of a slice
LANE_WORDS = 4            # own words a lane of csrc/sweep.cu scores a step
LOOP_OPS = 3              # a step's counter, compare and branch
SMS, CLOCK = 132, 1.98e9  # H100 SXM: SMs, boost clock
INT8_PEAK = 1979e12       # dense int8 tensor operations per second
POPC_RATE = 16 * SMS * CLOCK
INT_RATE = 64 * SMS * CLOCK


def _adder_gates(K: int) -> int:
    """Gates of the carry-save network that adds K // 5 three-plane
    five-sums and K % 5 single words into bit_length(K) planes: two a full
    or half adder, one an XOR of up to three words in the top plane."""
    q, r = divmod(K, 5)
    top = max(1, K.bit_length()) - 1
    gates = carries = 0
    for p in range(5):
        n = carries + (q + r if p == 0 else q if p < 3 else 0)
        if p == top:
            return gates + n // 2
        gates += 2 * (n // 2)
        carries = n // 2
    return gates


def ops_per_step(K: int, lane_words: int = LANE_WORDS) -> int:
    """Shifts and three-input gates a lane of `csrc/sweep.cu` spends on one
    offset, in which it scores 32 x lane_words window pairs: the mismatch
    and validity words, the five-sums, their shifted copies, the adder
    network and the sliced minimum. The loop's own instructions (LOOP_OPS)
    are not in it."""
    q, r = divmod(K, 5)
    n = lane_words
    ops = 6 * (n + 1) + 2 * n                # mismatch words, validity
    ops += 10 * n * (q >= 1) + 10 * (q >= 2)   # five-sums: 4 shifts, 6 gates
    copies = 3 * max(q - 1, 0) + r - (q == 0)  # a shift by 0 is free
    return ops + n * (copies + _adder_gates(K) + 11)


def tensor_ops_per_pair(K: int) -> int:
    """int8 tensor operations for one window pair: 2 x the one-hot row
    width, five codes a position padded to a multiple of 32 columns (128
    at K = 25, the min-match kernel's Cw)."""
    return 2 * (-(-5 * K // 32) * 32)


def pairs_of(G: int, K: int, d_lo: int, d_hi: int) -> int:
    """Window pairs (i, d) with d in [d_lo, d_hi) whose windows both fit."""
    n_win = G - K + 1
    d_hi = min(d_hi, n_win)
    return (d_hi - d_lo) * n_win - (d_lo + d_hi - 1) * (d_hi - d_lo) // 2


def floors_ms(pairs: int, K: int) -> dict[str, float]:
    per_pair = (ops_per_step(K) + LOOP_OPS) / (32 * LANE_WORDS)
    return {"tensor_ms": pairs * tensor_ops_per_pair(K) / INT8_PEAK * 1e3,
            "tensor_exact_ms": pairs * 2 * 5 * K / INT8_PEAK * 1e3,
            "popc_ms": pairs / POPC_RATE * 1e3,
            "sliced_ms": pairs * per_pair / INT_RATE * 1e3}


def chr4_like(seed: int = 4) -> np.ndarray:
    """Seeded random codes of chromosome IV's length with six N runs, then
    EOG."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, CHR4_LEN, dtype=np.uint8)
    for _ in range(6):
        d = int(rng.integers(0, CHR4_LEN - 400))
        g[d:d + int(rng.integers(50, 400))] = 4
    return np.append(g, 0x0F).astype(np.uint8)


def _time_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def time_slices(torch, sweep, seq: np.ndarray, ks=KS) -> list[dict]:
    """One dict per K and strand: K, strand, the REPS timed launches' ms, the
    slice's window pairs and its floors."""
    dev = torch.device("cuda")
    G = len(seq)
    rc = np.where(seq[::-1] < 4, 3 - seq[::-1], seq[::-1]).astype(np.uint8)
    own = torch.from_numpy(np.ascontiguousarray(seq)).to(dev)
    strands = (("sense", own, 1), ("antisense", torch.from_numpy(rc).to(dev), 0))
    out = []
    for K in ks:
        for strand, part, lo in strands:
            kw = dict(K=K, G_valid=G, d_lo=lo, d_hi=lo + SLICE)
            sweep(own, part, **kw)
            ms = [_time_ms(torch, lambda: sweep(own, part, **kw))
                  for _ in range(REPS)]
            pairs = pairs_of(G, K, lo, lo + SLICE)
            out.append({"K": K, "strand": strand, "ms": ms, "pairs": pairs,
                        **floors_ms(pairs, K)})
    return out


def main() -> int:
    import torch
    from kit4b_tpu_torch.kernels.sweep import sweep
    if not torch.cuda.is_available():
        print("time_sweep: CUDA is not available; this tool times the "
              "card's kernel", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    for row in time_slices(torch, sweep, chr4_like()):
        print(json.dumps({"G": CHR4_LEN + 1, "slice": SLICE, **row}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
