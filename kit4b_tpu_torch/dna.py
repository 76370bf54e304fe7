"""DNA base codes and the host-side codec, the port's own copy of
kit4b_tpu/dna.py (tests/test_torch_rehomed.py holds it equal to the
original).

The base-code scheme is interoperable with the reference's ``etSeqBase``
(reference: libkit4b/commdefs.h:75-87), so chromosome-boundary sentinel
logic carries over unchanged:

    A=0  C=1  G=2  T=3  N=4  UNDEF=5  INDEL=6  EOS=7  EOG=0x0f
"""
from __future__ import annotations

import numpy as np

BASE_A = 0
BASE_C = 1
BASE_G = 2
BASE_T = 3
BASE_N = 4
BASE_UNDEF = 5
BASE_INDEL = 6
BASE_EOS = 7  # end-of-sequence (chromosome) separator in concatenated genomes
BASE_EOG = 0x0F  # end-of-genome marker

_ASCII2CODE = np.full(256, BASE_N, dtype=np.uint8)
for _ch, _code in (
    ("A", BASE_A), ("C", BASE_C), ("G", BASE_G), ("T", BASE_T),
    ("a", BASE_A), ("c", BASE_C), ("g", BASE_G), ("t", BASE_T),
    ("U", BASE_T), ("u", BASE_T),
    ("N", BASE_N), ("n", BASE_N),
    ("-", BASE_INDEL),
):
    _ASCII2CODE[ord(_ch)] = _code

_CODE2ASCII = np.full(16, ord("?"), dtype=np.uint8)
for _code, _ch in ((BASE_A, "A"), (BASE_C, "C"), (BASE_G, "G"), (BASE_T, "T"),
                   (BASE_N, "N"), (BASE_UNDEF, "?"), (BASE_INDEL, "-"),
                   (BASE_EOS, "|"), (BASE_EOG, "$")):
    _CODE2ASCII[_code] = ord(_ch)

# complement: A<->T, C<->G; N and sentinels map to themselves
_COMPLEMENT = np.arange(16, dtype=np.uint8)
_COMPLEMENT[BASE_A] = BASE_T
_COMPLEMENT[BASE_T] = BASE_A
_COMPLEMENT[BASE_C] = BASE_G
_COMPLEMENT[BASE_G] = BASE_C


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 base codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _ASCII2CODE[raw]


def decode(codes: np.ndarray) -> str:
    """uint8 base codes -> ASCII string."""
    return _CODE2ASCII[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def complement(codes: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[np.asarray(codes, dtype=np.uint8)]


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[np.asarray(codes, dtype=np.uint8)][::-1]


def pack2bit(codes: np.ndarray, word_dtype=np.uint32) -> np.ndarray:
    """Pack base codes (must be 0..3; callers mask Ns first) into 2-bit lanes.

    Little-endian within each word: base i occupies bits (2*i, 2*i+1) of
    word i//bases_per_word. Length is padded with zeros (=A).
    """
    codes = np.asarray(codes, dtype=np.uint8) & 0x3
    bits_per = np.dtype(word_dtype).itemsize * 8
    bases_per_word = bits_per // 2
    n = len(codes)
    nwords = (n + bases_per_word - 1) // bases_per_word
    padded = np.zeros(nwords * bases_per_word, dtype=np.uint64)
    padded[:n] = codes
    padded = padded.reshape(nwords, bases_per_word)
    shifts = (2 * np.arange(bases_per_word, dtype=np.uint64))[None, :]
    return (padded << shifts).sum(axis=1).astype(word_dtype)


def kmer_codes_to_int(codes: np.ndarray) -> int:
    """First-base-major integer encoding of a k-mer (k <= 31)."""
    v = 0
    for c in np.asarray(codes, dtype=np.uint64):
        v = (v << 2) | int(c & 0x3)
    return v
