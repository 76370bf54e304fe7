"""Bit operations on 32-bit words with stated widths.

The JAX passes compute on `uint32` words. Torch's `uint32` has no `>>`,
`<<` or `~`, and its `int32 >>` is an arithmetic shift, so the port carries
every 32-bit word in an **int64 tensor holding the word's low 32 bits**
(values in [0, 2^32)). On that carrier `&`, `|`, `^` and `>>` are the
uint32 operations as they are (a right shift of a non-negative value is
logical), `<<` and `~` mask back to 32 bits, and a shift by 32 gives 0 as
XLA's logical shifts do. Counts, indices and codes stay int32 as in JAX.

Gathers and scatters state their bounds: JAX clamps out-of-range gather
indices and `.at[...].set/add(mode="drop")` drops out-of-range updates,
where torch raises.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_M8 = 0x00FF00FF
_M16 = 0x0000FFFF


def shr32(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of int64-carried 32-bit words by s (0..32)."""
    return x >> s


def shl32(x: torch.Tensor, s) -> torch.Tensor:
    """Left shift of int64-carried 32-bit words by s (0..32), kept to 32
    bits."""
    return (x << s) & M32


def not32(x: torch.Tensor) -> torch.Tensor:
    """Bitwise NOT of int64-carried 32-bit words."""
    return x ^ M32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64-carried 32-bit word (SWAR), as int32."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F).to(torch.int32)


def bitrev2(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit groups of each int64-carried 32-bit word
    (`seed_extend_v4._bitrev2`)."""
    x = (x >> 16) | ((x & _M16) << 16)
    x = ((x >> 8) & _M8) | ((x & _M8) << 8)
    x = ((x >> 4) & _M4) | ((x & _M4) << 4)
    return ((x >> 2) & _M2) | ((x & _M2) << 2)


def to_words(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy array -> int64 word carrier (on the CPU)."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64))


def take_clamped(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] along dim 0 with idx clamped to [0, len - 1], as the JAX
    passes clip their gather indices (`sa[jnp.clip(i, 0, M - 1)]`)."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


def _drop_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX `mode="drop"` index map onto a dump slot n: negative indices
    wrap once, what is still out of [0, n) goes to n."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))


def scatter_set_drop(dst: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor) -> torch.Tensor:
    """`dst.at[idx].set(vals, mode="drop")` for a 1-D dst whose in-range
    targets are distinct; returns a new tensor."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    ext[_drop_index(idx, n)] = vals.to(dst.dtype)
    return ext[:n]


def scatter_add_drop_2d(dst: torch.Tensor, i0: torch.Tensor, i1: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """`dst.at[i0, i1].add(vals, mode="drop")` for a 2-D dst; an update is
    dropped when either index is out of range. Returns a new tensor."""
    n0, n1 = dst.shape
    a = _drop_index(i0, n0)
    b = _drop_index(i1, n1)
    flat = torch.where((a < n0) & (b < n1), a * n1 + b,
                       torch.full_like(a, n0 * n1))
    ext = torch.cat([dst.reshape(-1), dst.new_zeros(1)])
    ext.index_put_((flat,), vals.to(dst.dtype), accumulate=True)
    return ext[:n0 * n1].reshape(n0, n1)
