"""The yardstick of the kernels: the card's peaks and the work of each hand
kernel, counted from shapes and never from the kernel.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at its
full power limit of 700 W.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops_per_s": 1979e12,
                              "hbm_bytes_per_s": 3.35e12},
}
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def peaks(card: str) -> dict:
    """The peaks of `card`, or of the H100 SXM where the name is not in the
    table (the benchmark runs on that card)."""
    return PEAKS.get(card, PEAKS[DEFAULT_CARD])


def minmm_ops(rows: int, cols: int, cw: int) -> int:
    """int8 tensor operations of one max-match product: every own row
    against every partner column, a multiply and an add for each of the
    row's `cw` one-hot channels."""
    return 2 * rows * cols * cw


def minmm_bytes(rows: int, cols: int, cw: int) -> int:
    """Bytes each input is read once and the output written once: the own
    rows and partner columns of int8 one-hot channels, an int32 a row."""
    return rows * cw + cols * cw + 4 * rows


def minmm_bound_s(rows: int, cols: int, cw: int, card: str) -> float:
    """The least time the card could take for one product: operations over
    the int8 tensor peak or bytes over the memory rate, the larger."""
    pk = peaks(card)
    return max(minmm_ops(rows, cols, cw) / pk["int8_ops_per_s"],
               minmm_bytes(rows, cols, cw) / pk["hbm_bytes_per_s"])


def one_hot_width(K: int) -> int:
    """Channels of a K-mer's one-hot row: 5 codes a base (A, C, G, T, N),
    padded to the tensor unit's 128."""
    return -(-5 * K // 128) * 128


def hammings_node_shape(G: int, K: int, node: int, numnodes: int,
                        antisense: bool) -> dict:
    """The work an exhaustive node run needs (`hammings -n/-N`): every one
    of the padded genome's Gp own rows meets every partner column of the
    node's share, once for each strand."""
    from .reference.hammings import node_columns
    Gp, c0, c1 = node_columns(G, node, numnodes)
    return {"rows": Gp, "cols": c1 - c0, "cw": one_hot_width(K),
            "strands": 2 if antisense else 1}
