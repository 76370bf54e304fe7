"""A numpy model of the 2:4 compression of csrc/wgmma_sp.cuh and of the
fragments csrc/minmm.cu builds from it, on the CPU.

`sp_group`, `sp_meta` and `sp_vals` repeat the header's functions on numpy
words. The kernel's consumer threads call `sp_meta` and `sp_vals` at the
rows and bytes `fragments` gives; the instruction reads the registers as
`decompress` does (the layouts in the header's note, CUTLASS's
ELayout_64x64 and ALayout_64x64). Held here: every own row of one-hot
windows comes back whole from its compressed form, so the sparse product
equals the dense one; each group is counted once; the indices are distinct
and ascending. Change the model and the `.cu` together.
"""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch.kmer.hammings_mxu import onehot_windows
from kit4b_tpu_torch.tools.probe_minmm_sp import two_of_four_rows


def sp_group(w: np.ndarray) -> tuple[int, int, int, int, int]:
    """(value at i0, value at i1, i0, i1, faults) of a group of 4 int8."""
    nz = [j for j in range(4) if w[j] != 0]
    bad = int(len(nz) > 2)
    if len(nz) > 2:
        nz = nz[:2]
    elif len(nz) < 2:
        m = {j for j in nz} | {0}
        if m == {0}:
            m.add(1)
        nz = sorted(m)
    i0, i1 = nz
    return int(w[i0]), int(w[i1]), i0, i1, bad


def sp_meta(tile: np.ndarray, row: int, byte0: int) -> tuple[int, int]:
    """(metadata register, faults) of channels [byte0, byte0 + 32)."""
    e = bad = 0
    for j in range(8):
        _, _, i0, i1, b = sp_group(tile[row, byte0 + 4 * j:byte0 + 4 * j + 4])
        e |= (i0 | i1 << 2) << (4 * j)
        bad += b
    return e, bad


def sp_vals(tile: np.ndarray, row: int, byte0: int) -> list[int]:
    """The 4 kept values of channels [byte0, byte0 + 8), in register order."""
    out = []
    for j in range(2):
        v0, v1, *_ = sp_group(tile[row, byte0 + 4 * j:byte0 + 4 * j + 4])
        out += [v0, v1]
    return out


def fragments(tile: np.ndarray, s: int):
    """Each thread's metadata and 4 value registers of k-step s (channels
    [64 s, 64 s + 64)) of a 64-row pass, as minmm.cu's consumers build
    them; with the faults the metadata counted."""
    e = np.zeros(128, np.int64)
    a = np.zeros((128, 4, 4), np.int64)
    bad = 0
    for tid in range(128):
        warp, lane = tid >> 5, tid & 31
        lrow = warp * 16 + (lane >> 2)
        byte0 = 64 * s
        e[tid], b = sp_meta(tile, lrow + 8 * (lane & 1),
                            byte0 + 32 * ((lane >> 1) & 1))
        bad += b
        for i in range(4):
            a[tid, i] = sp_vals(tile, lrow + 8 * (i & 1),
                                byte0 + 8 * (lane & 3) + 32 * (i >> 1))
    return e, a, bad


def decompress(e, a) -> tuple[np.ndarray, np.ndarray]:
    """The 64 x 64 tile the instruction multiplies, and how many threads'
    metadata covers each (row, group)."""
    idx = np.full((64, 16, 2), -1)
    cover = np.zeros((64, 16), int)
    for tid in range(128):
        warp, lane = tid >> 5, tid & 31
        row = 16 * warp + (lane >> 2) + 8 * (lane & 1)
        for j in range(8):
            g = 8 * ((lane >> 1) & 1) + j
            nib = (int(e[tid]) >> (4 * j)) & 0xF
            idx[row, g] = nib & 3, nib >> 2
            cover[row, g] += 1
    A = np.zeros((64, 64), np.int64)
    for tid in range(128):
        warp, lane = tid >> 5, tid & 31
        for i in range(4):
            row = 16 * warp + (lane >> 2) + 8 * (i & 1)
            for q in range(4):   # compressed byte 4(l&3) + 16(i>>1) + q
                cb = 4 * (lane & 3) + 16 * (i >> 1) + q
                g, k = cb // 2, cb % 2
                A[row, 4 * g + idx[row, g, k]] += a[tid, i, q]
    return A, cover


def _onehot(K: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, 64 + K).astype(np.uint8)
    codes[rng.integers(0, 64 + K, 5)] = 4
    codes[30] = 7
    return onehot_windows(torch.from_numpy(codes), 0, 64, K=K,
                          G=64 + K - 3)[0].numpy()


@pytest.mark.parametrize("rows", ["onehot K 25", "onehot K 153",
                                  "two of four"])
def test_fragments_decompress_to_the_tile(rows):
    W = {"onehot K 25": lambda: _onehot(25, 1),
         "onehot K 153": lambda: _onehot(153, 2),
         "two of four": lambda: two_of_four_rows(np.random.default_rng(3),
                                                 64)}[rows]()
    for s in range(W.shape[1] // 64):
        e, a, bad = fragments(W, s)
        A, cover = decompress(e, a)
        assert bad == 0 and (cover == 1).all()
        np.testing.assert_array_equal(A, W[:, 64 * s:64 * s + 64])
        B = np.random.default_rng(s).integers(-2, 3, (256, 64))
        np.testing.assert_array_equal(A @ B.T,
                                      W[:, 64 * s:64 * s + 64] @ B.T)


def test_groups_past_2_of_4_are_counted_once():
    W = _onehot(25, 4)
    W[5, :3] = 1          # 3 non-zeros
    W[40, 60:64] = -1     # 4
    W[63, 33:35] = 1      # 2: fine
    _, _, bad = fragments(W, 0)
    assert bad == 2


@pytest.mark.parametrize("m", range(16))
def test_every_group_keeps_distinct_ascending_indices(m):
    w = np.array([(m >> j & 1) * (j + 1) for j in range(4)], np.int8)
    v0, v1, i0, i1, bad = sp_group(w)
    assert 0 <= i0 < i1 <= 3 and bad == (bin(m).count("1") > 2)
    if not bad:   # the kept values hold every non-zero
        kept = np.zeros(4, np.int8)
        kept[[i0, i1]] = v0, v1
        np.testing.assert_array_equal(kept, w)
