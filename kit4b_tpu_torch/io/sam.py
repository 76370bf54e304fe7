"""SAM flag bits and the per-record SEQ/QUAL helper the port's SAM writers
use (the values and the function of kit4b_tpu/io/sam.py)."""
from __future__ import annotations

import numpy as np

from .. import dna

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80


def seq_qual_for_strand(codes: np.ndarray, qual: np.ndarray | None,
                        reverse: bool) -> tuple[str, str]:
    """SEQ/QUAL strings; '-' strand hits emit the reverse complement
    (KAligner.cpp:6134-6145)."""
    if reverse:
        codes = dna.revcomp(codes)
        if qual is not None:
            qual = qual[::-1]
    seq = dna.decode(codes)
    q = "*" if qual is None else (np.asarray(qual, np.uint8) + 33
                                  ).tobytes().decode("ascii")
    return seq, q
