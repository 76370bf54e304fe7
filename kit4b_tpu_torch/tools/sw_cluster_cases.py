"""Banded Smith-Waterman cases built to break csrc/sw.cu's cluster scan and
tiled traceback, from numpy seeds. Each is a batch as
`make_pacbio_golden.sw_cases()` builds them (`_batch`), so the same
helpers (`padded`, `engine`) take it:

    peak ties         the global maximum in two rows (lane 1), and twice in
                      one row in two blocks of the cluster (lane 0)
    gap runs          an insertion run (F, in-row) and a deletion run (E,
                      down the rows) of 80 across warp edges and the block
                      edge at k 1,024; the I run leaves its tile through
                      the left side, the D run crosses tiles downwards
    band edges        paths on k = 0 and k = W - 1 in the first and the last
                      block, at W 1,024 (2 columns a thread, one block) and
                      W 2,049 (a thread holding column 2,048 and three idle
                      ones, two blocks)
    W 1 ... W 8192    bands 1, 600, 1,500, 2,049, 3,000, 4,097 and 8,192: W not a
                      multiple of P x 32 x C
    B 1 ... B 200     the cluster sizes 8, 4, 2 and 1 that scan_layout picks
    stops             walks that end on i < 0, on c < 0, on H0 == 0 and at
                      best <= 0 beside a path that drifts out of the band
                      (the tests cut every walk at L_OPS too)
    long walk         1,500 and 1,200 rows of few errors: many tiles, each
                      entered from the prefetched one
    traceback=False   no pointer bytes

A scan never sends a walk out of the band (F is NEG at k = 0, and E at
k = W - 1 never extends), so `random_pointer_cases()` adds pointer arrays
of seeded random bytes (a valid dirb in bits 0-1): their walks cross the
band's edges, run in every direction through the tiles, and stop on every
rule.

tests/test_torch_sw_model.py runs them through a numpy model of the
kernels, tests/test_torch_sw_cluster_jax.py the plain versions against
JAX on the CPU, and tests/test_torch_sw_card.py and chip_smoke.py phase
15b the kernels against the plain versions on the card.
"""
import numpy as np

from kit4b_tpu_torch.tools import make_pacbio_golden as mg

SEED = 1313


def cluster_cases() -> list[dict]:
    rng = np.random.default_rng(SEED)

    def rand(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    cases = []
    # W 2,048 at B 2 is two blocks a pair, 1,024 columns each (16 warps of
    # 64 columns)
    W = 2048
    n6 = np.full(6, 4, np.uint8)      # N flanks: no path carries on past s
    s = np.concatenate([n6, rand(60), n6])
    p0 = np.concatenate([rand(294), s, rand(294)])    # s ends at row 359
    t0 = np.concatenate([rand(70), s, rand(428), s, rand(46)])   # k 800, 1300
    p1 = np.concatenate([rand(94), s, rand(188), s, rand(94)])   # rows 159, 419
    t1 = np.concatenate([rand(235), s, rand(194)])    # ends at column 300
    cases.append(mg._batch("peak ties", [(p0, t0), (p1, t1)], 660, 700,
                           [0, 0], W))
    a = rand(600)
    gap = rand(80)
    ins = np.concatenate([a[:300], gap, a[300:]])
    cases.append(mg._batch("gap runs", [(a, ins), (ins, a)], 680, 680,
                           [40, -40], W, scores="ecreads"))
    W = 1024
    a, b = rand(400), rand(400)
    cases.append(mg._batch("band edges W 1024", [(a, a), (b, b)], 400, 400,
                           [W // 2, W // 2 - (W - 1)], W))
    W = 2049
    cases.append(mg._batch("band edges W 2049", [(a, a), (b, b)], 400, 400,
                           [W // 2, W // 2 - (W - 1)], W))
    for W, n in ((1, 200), (600, 200), (1500, 200), (2049, 200),
                 (3000, 200), (4097, 200), (8192, 200)):
        pairs = []
        for d in (0, 9):
            a = rand(n)
            pairs.append((a, np.concatenate([rand(d), mg.mutate(rng, a)])))
        cases.append(mg._batch(f"W {W}", pairs, n, n + 40, [0, 9], W,
                               scores="tests"))
    for B, W in ((1, 8192), (3, 4096), (33, 2048), (200, 300)):
        pairs = []
        for _ in range(B):
            a = rand(int(rng.integers(60, 120)))
            pairs.append((a, mg.mutate(rng, a, 0.04, 0.08)))
        cases.append(mg._batch(f"B {B}", pairs, 120, 150,
                               rng.integers(-5, 6, B), W, scores="ecreads"))
    a = rand(300)
    drift = np.concatenate([a[:100], rand(60), a[100:]])
    cases.append(mg._batch(
        "stops", [(a, np.concatenate([rand(50), a])),       # i < 0
                  (np.concatenate([rand(50), a]), a),       # c < 0
                  (a, drift),                               # out of band
                  (np.concatenate([rand(80), a, rand(80)]),
                   np.concatenate([rand(80), a, rand(80)])),   # H0 == 0
                  (a[:0], a)],                              # best <= 0
        460, 460, [50, -50, 0, 0, 0], 64, scores="tests"))
    a, b = rand(1500), rand(1200)
    cases.append(mg._batch(
        "long walk", [(a, mg.mutate(rng, a, 0.01, 0.02)),
                      (b, mg.mutate(rng, b, 0.02, 0.03))],
        1500, 1560, [0, 0], 300, scores="pbassemb"))
    a = rand(300)
    cases.append(mg._batch("traceback=False",
                           [(a, mg.mutate(rng, a)), (a[:0], a),
                            (a, a)], 300, 330, [0, 0, 3], 1024,
                           traceback=False))
    return cases


def random_pointer_cases() -> list[dict]:
    """Traceback inputs over random pointer bytes: dirb 0 (stop) rarely, 1
    or 2 otherwise, bits 2-4 at random, or in one set mostly 2 with the eext
    bit alone (long D runs, which drift right through the tiles); the last
    lane has best 0."""
    rng = np.random.default_rng(SEED + 1)
    cases = []
    for W, Lp, B, runs in ((64, 600, 4, False), (300, 700, 3, False),
                           (1025, 300, 2, False), (300, 400, 2, True)):
        # `runs`: up moves that extend, so the walk drifts right 1 a row
        d = rng.choice(np.array([0, 1, 2], np.uint8), size=(Lp, B, W),
                       p=[0.001, 0.1, 0.899] if runs else [0.004, 0.66, 0.336])
        bits = rng.integers(0, 8, (Lp, B, W))
        if runs:
            bits = np.where(rng.random((Lp, B, W)) < 0.97, 2, bits)
        ptrs = d | (bits << 2).astype(np.uint8)
        best = np.full(B, 5, np.int32)
        best[-1] = 0
        cases.append(dict(
            label=f"random bytes W {W}" + (", D runs" if runs else ""),
            ptrs=ptrs,
            probes=rng.integers(0, 5, (B, Lp)).astype(np.uint8),
            targets=rng.integers(0, 5, (B, Lp + W)).astype(np.uint8),
            best=best,
            bi=(Lp - 1 - rng.integers(0, 50, B)).astype(np.int32),
            bk=rng.integers(0, W, B).astype(np.int32),
            diag0=rng.integers(-20, 21, B).astype(np.int32), W=W,
            L_OPS=Lp + W))
    return cases
