"""The yardstick of the kernels: the card's peaks and the work of each hand
kernel, counted from shapes and never from the kernel.

Peaks are NVIDIA's data sheet for one H100 SXM, at its full power limit of
700 W: the dense rates, and the int8 tensor rate with 2:4 structured
sparsity (3,958 TOP/s, twice the dense 1,979), which `wgmma.mma_async.sp`
reaches when one operand holds at most 2 non-zeros in every aligned group
of 4 along the reduction.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops_per_s": 1979e12,
                              "int8_sparse_ops_per_s": 3958e12,
                              "hbm_bytes_per_s": 3.35e12},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"
SPARSE_K_STEP = 64      # int8 reduction of one m64nNk64 .sp instruction


def peaks(card: str) -> dict:
    """The peaks of `card`, or of the H100 SXM where the name is not in the
    table (the benchmark runs on that card)."""
    return PEAKS.get(card, PEAKS[DEFAULT_CARD])


def minmm_ops(rows: int, cols: int, channels: int) -> int:
    """int8 tensor operations of one max-match product: every own row
    against every partner column, a multiply and an add for each of
    `channels` one-hot channels."""
    return 2 * rows * cols * channels


def minmm_bytes(rows: int, cols: int, cw: int) -> int:
    """Bytes each input is read once and the output written once: the own
    rows and partner columns of int8 one-hot channels, an int32 a row."""
    return rows * cw + cols * cw + 4 * rows


def sparse_channels(K: int) -> int:
    """Channels of a K-mer's one-hot row that the 2:4-sparse product
    reduces: its 5K, padded to the sparse instruction's k-step.

    The one-hot is 2:4-structured by construction: a base takes 5
    consecutive channels and holds at most one 1 among them, so an aligned
    group of 4 channels touches at most 2 bases and holds at most 2 ones
    (the padding none). Taken as the sparse operand, the own rows need
    2·rows·cols·sparse_channels(K) operations at the sparse rate, the
    fastest the tensor cores take these inputs by any exact method known
    here: half of the dense product over 128 channels at K 25, and no more
    than the dense product over 3 channels a base (96 wide at K 25)."""
    return -(-5 * K // SPARSE_K_STEP) * SPARSE_K_STEP


def minmm_bound_s(rows: int, cols: int, K: int, card: str) -> float:
    """The least time the card could take for one product of K-mer rows:
    the 2:4-sparse operations over the sparse int8 tensor peak, or the
    bytes of the stored one-hot over the memory rate, the larger."""
    pk = peaks(card)
    return max(minmm_ops(rows, cols, sparse_channels(K))
               / pk["int8_sparse_ops_per_s"],
               minmm_bytes(rows, cols, one_hot_width(K))
               / pk["hbm_bytes_per_s"])


def one_hot_width(K: int) -> int:
    """Channels of a K-mer's one-hot row as the program stores it: 5 codes
    a base (A, C, G, T, N), padded to the tensor unit's 128."""
    return -(-5 * K // 128) * 128


def hammings_node_shape(G: int, K: int, node: int, numnodes: int,
                        antisense: bool) -> dict:
    """The work an exhaustive node run needs (`hammings -n/-N`): every one
    of the padded genome's Gp own rows meets every partner column of the
    node's share, once for each strand."""
    from .reference.hammings import node_columns
    Gp, c0, c1 = node_columns(G, node, numnodes)
    return {"rows": Gp, "cols": c1 - c0, "K": K,
            "strands": 2 if antisense else 1}
