"""BAM output/input with BGZF compression: the port's copy of
kit4b_tpu/io/bam.py (tests/test_torch_bam.py holds its bytes equal to the
original's).

Capability parity with the reference's BAM path (libkit4b/bgzf.cpp +
ngskit4b/KAligner.cpp:5718 WriteBAMReadHits): BGZF blocks (gzip members with
the BC extra subfield, <=64KB payload, EOF marker block) wrapping the BAM1
binary record layout, with a BAI or CSI index beside it. Pure python/zlib:
the writer streams SamAlignment records, sharing the SamWriter interface; a
minimal reader serves the tests and chip_smoke.py.

The compressed bytes, and so the virtual offsets of the BAI and CSI, are
zlib's level-6 deflate output: two machines write the same bytes only with
the same zlib (`zlib.ZLIB_RUNTIME_VERSION`); the decompressed payload is
the same everywhere.
"""
from __future__ import annotations

import bisect
import struct
import zlib

from .sam import SamAlignment

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


class BgzfWriter:
    def __init__(self, path):
        self._f = open(path, "wb")
        self._buf = bytearray()
        self.u_pos = 0               # total uncompressed bytes accepted
        self._u_flushed = 0          # uncompressed bytes already in blocks
        # per flushed block: (uncompressed start, compressed file offset)
        self.block_map: list[tuple[int, int]] = [(0, 0)]
        self._u_starts: list[int] = []   # block_map's first column

    def write(self, data: bytes) -> None:
        self._buf += data
        self.u_pos += len(data)
        while len(self._buf) >= 60000:
            self._flush_block(self._buf[:60000])
            del self._buf[:60000]

    def virtual_offset(self, u: int) -> int:
        """BGZF virtual offset (coffset<<16 | uoffset) of uncompressed
        position u. Valid for positions in already-started blocks; the block
        map is final once every position <= u has been flushed (call after
        close for trailing records)."""
        if len(self._u_starts) != len(self.block_map):
            self._u_starts = [b[0] for b in self.block_map]
        i = bisect.bisect_right(self._u_starts, u) - 1
        u_start, c_off = self.block_map[i]
        return (c_off << 16) | (u - u_start)

    def _flush_block(self, payload: bytes) -> None:
        self._u_flushed += len(payload)
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(payload)) + co.flush()
        bsize = len(cdata) + 25 + 1
        block = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                 + struct.pack("<HHH", 6, 0x4342, 2)
                 + struct.pack("<H", bsize - 1)
                 + cdata
                 + struct.pack("<II", zlib.crc32(bytes(payload)),
                               len(payload)))
        self._f.write(block)
        self.block_map.append((self._u_flushed, self._f.tell()))

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._f.write(BGZF_EOF)
        self._f.close()


def read_bgzf(path) -> bytes:
    """Decompress a whole BGZF file (gzip members concatenate)."""
    out = bytearray()
    d = zlib.decompressobj(31)
    data = open(path, "rb").read()
    while data:
        out += d.decompress(data)
        data = d.unused_data
        d = zlib.decompressobj(31)
    return bytes(out)


def _encode_cigar(cigar: str) -> list[int]:
    if cigar == "*":
        return []
    out = []
    num = ""
    for ch in cigar:
        if ch.isdigit():
            num += ch
        else:
            out.append((int(num) << 4) | _CIGAR_OPS.index(ch))
            num = ""
    return out


def _reg2bin(beg: int, end: int) -> int:
    """UCSC binning (SAM spec; KAligner.cpp:5930 BAMreg2bin)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BamWriter:
    """SamWriter-compatible BAM writer.

    index=True also writes `path + ".bai"` on close (UCSC-binning BAI, the
    reference's WriteBAMReadHits -M6 path, KAligner.cpp:5718/5930);
    index="csi" writes the CSI variant instead (generalized binning for
    >512 Mbp chromosomes, libkit4b/SAMfile.h:21-58 eSFTBAM_CSI). Either
    index is only meaningful when records are written coordinate-sorted,
    as the reference does (it sorts accepted hits by chrom/loci first).
    """

    def __init__(self, path, chrom_names, chrom_lengths,
                 pg_name: str = "kit4b_tpu", pg_cl: str = "",
                 index: bool = False):
        self._path = str(path)
        self._w = BgzfWriter(path)
        self._index = index
        self._n_ref = len(chrom_names)
        # per record: (ref_id, beg, end, u_start, u_end)
        self._recs: list[tuple] = []
        self._refs = {n: i for i, n in enumerate(chrom_names)}
        # indexed BAMs are written coordinate-sorted (kalign buffers + sorts
        # before the indexed path); SO must say so for samtools/htsjdk
        so = "coordinate" if index else "unsorted"
        text = f"@HD\tVN:1.4\tSO:{so}\n"
        for name, ln in zip(chrom_names, chrom_lengths):
            text += f"@SQ\tSN:{name}\tLN:{int(ln)}\n"
        text += f"@PG\tID:{pg_name}\tPN:{pg_name}\tCL:{pg_cl}\n"
        hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode()
        hdr += struct.pack("<i", len(chrom_names))
        for name, ln in zip(chrom_names, chrom_lengths):
            nb = name.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i",
                                                                 int(ln))
        self._w.write(hdr)

    def write(self, a: SamAlignment) -> None:
        ref_id = self._refs.get(a.rname, -1)
        pos = a.pos - 1
        name = a.qname.encode() + b"\x00"
        cigar = _encode_cigar(a.cigar)
        seq = a.seq if a.seq != "*" else ""
        l_seq = len(seq)
        packed = bytearray((l_seq + 1) // 2)
        for i, ch in enumerate(seq):
            nib = _SEQ_NIBBLE.get(ch.upper(), 15)
            packed[i // 2] |= nib << (4 if i % 2 == 0 else 0)
        qual = (bytes(255 for _ in range(l_seq)) if a.qual == "*"
                else bytes(max(0, min(93, ord(q) - 33)) for q in a.qual))
        if a.rnext == "=":
            next_ref = ref_id
        else:
            next_ref = self._refs.get(a.rnext, -1)
        end = pos + sum(c >> 4 for c in cigar
                        if _CIGAR_OPS[c & 0xF] in "MDN=X") if cigar else \
            pos + 1
        tags = b""
        for t in a.tags:
            tag, typ, val = t.split(":", 2)
            if typ == "i":
                tags += tag.encode() + b"i" + struct.pack("<i", int(val))
            else:
                tags += tag.encode() + b"Z" + val.encode() + b"\x00"
        rec = struct.pack(
            "<iiBBHHHiiii", ref_id, pos if ref_id >= 0 else -1,
            len(name), a.mapq, _reg2bin(max(pos, 0), max(end, 1)),
            len(cigar), a.flag, l_seq, next_ref,
            (a.pnext - 1) if a.pnext else -1, a.tlen)
        rec += name + b"".join(struct.pack("<I", c) for c in cigar)
        rec += bytes(packed) + qual + tags
        u_start = self._w.u_pos
        self._w.write(struct.pack("<i", len(rec)) + rec)
        if self._index and ref_id >= 0:
            self._recs.append((ref_id, max(pos, 0), max(end, pos + 1),
                               u_start, self._w.u_pos))

    def close(self) -> None:
        self._w.close()
        if self._index == "csi":
            write_csi(self._path + ".csi", self._recs, self._n_ref,
                      self._w)
        elif self._index:
            write_bai(self._path + ".bai", self._recs, self._n_ref, self._w)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_bai(path, recs, n_ref: int, bgzf: BgzfWriter) -> None:
    """BAI index (SAM spec section 5.2): per reference, UCSC bins -> chunk
    lists of BGZF virtual offsets, plus a 16kb-window linear index."""
    per_ref_bins: list[dict] = [dict() for _ in range(n_ref)]
    per_ref_linear: list[dict] = [dict() for _ in range(n_ref)]
    for ref_id, beg, end, u0, u1 in recs:
        v0 = bgzf.virtual_offset(u0)
        v1 = bgzf.virtual_offset(u1)
        b = _reg2bin(beg, end)
        per_ref_bins[ref_id].setdefault(b, []).append((v0, v1))
        lin = per_ref_linear[ref_id]
        for w in range(beg >> 14, ((end - 1) >> 14) + 1):
            if w not in lin or v0 < lin[w]:
                lin[w] = v0
    with open(path, "wb") as f:
        f.write(b"BAI\x01" + struct.pack("<i", n_ref))
        for bins, lin in zip(per_ref_bins, per_ref_linear):
            # merge adjacent chunks within each bin
            merged_bins = {}
            for b, chunks in bins.items():
                chunks.sort()
                out = [list(chunks[0])]
                for c0, c1 in chunks[1:]:
                    if c0 == out[-1][1]:
                        out[-1][1] = c1
                    else:
                        out.append([c0, c1])
                merged_bins[b] = out
            f.write(struct.pack("<i", len(merged_bins)))
            for b in sorted(merged_bins):
                chunks = merged_bins[b]
                f.write(struct.pack("<Ii", b, len(chunks)))
                for c0, c1 in chunks:
                    f.write(struct.pack("<QQ", c0, c1))
            n_intv = (max(lin) + 1) if lin else 0
            f.write(struct.pack("<i", n_intv))
            prev = 0
            for w in range(n_intv):
                v = lin.get(w, prev)
                f.write(struct.pack("<Q", v))
                prev = v


def read_bam(path):
    """Minimal BAM reader yielding SamAlignment records."""
    data = read_bgzf(path)
    assert data[:4] == b"BAM\x01", "not a BAM file"
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        refs.append(data[off:off + l_name - 1].decode())
        off += l_name + 4
    while off < len(data):
        (block,) = struct.unpack_from("<i", data, off)
        off += 4
        (ref_id, pos, l_name, mapq, _bin, n_cig, flag, l_seq, nref, npos,
         tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
        p = off + 32
        qname = data[p:p + l_name - 1].decode()
        p += l_name
        cig = ""
        for _ in range(n_cig):
            (c,) = struct.unpack_from("<I", data, p)
            cig += f"{c >> 4}{_CIGAR_OPS[c & 0xF]}"
            p += 4
        seq = ""
        for i in range(l_seq):
            nib = (data[p + i // 2] >> (4 if i % 2 == 0 else 0)) & 0xF
            seq += "=ACMGRSVTWYHKDBN"[nib]
        p += (l_seq + 1) // 2
        qual = data[p:p + l_seq]
        quals = ("*" if (l_seq == 0 or qual[0] == 255)
                 else "".join(chr(q + 33) for q in qual))
        p += l_seq
        tags = []
        end = off + block
        while p < end:
            tag = data[p:p + 2].decode()
            typ = chr(data[p + 2])
            p += 3
            if typ in "cC":
                val, p = str(struct.unpack_from(
                    "<b" if typ == "c" else "<B", data, p)[0]), p + 1
                typ = "i"
            elif typ in "sS":
                val, p = str(struct.unpack_from(
                    "<h" if typ == "s" else "<H", data, p)[0]), p + 2
                typ = "i"
            elif typ in "iI":
                val, p = str(struct.unpack_from(
                    "<i" if typ == "i" else "<I", data, p)[0]), p + 4
                typ = "i"
            elif typ == "f":
                val, p = repr(struct.unpack_from("<f", data, p)[0]), p + 4
            elif typ in "ZH":
                z = data.index(b"\x00", p)
                val, p = data[p:z].decode(), z + 1
            elif typ == "A":
                val, p = chr(data[p]), p + 1
            else:  # B array — skip
                atyp = chr(data[p])
                (n,) = struct.unpack_from("<i", data, p + 1)
                sz = {"c": 1, "C": 1, "s": 2, "S": 2,
                      "i": 4, "I": 4, "f": 4}[atyp]
                p += 5 + n * sz
                continue
            tags.append(f"{tag}:{typ}:{val}")
        yield SamAlignment(
            qname, flag, refs[ref_id] if ref_id >= 0 else "*", pos + 1,
            mapq, cig or "*",
            ("=" if nref == ref_id and nref >= 0 else
             (refs[nref] if nref >= 0 else "*")),
            npos + 1 if npos >= 0 else 0, tlen, seq or "*", quals,
            tags=tags)
        off += block  # past this record (block_size counts the record body)


def _csi_reg2bin(beg: int, end: int, min_shift: int, depth: int) -> int:
    """Generalized CSI binning (SAM spec 5.3; reduces to _reg2bin at
    min_shift=14, depth=5)."""
    end -= 1
    s = min_shift
    t = ((1 << (depth * 3)) - 1) // 7
    for lvl in range(depth, 0, -1):
        if beg >> s == end >> s:
            return t + (beg >> s)
        s += 3
        t -= 1 << (lvl * 3 - 3)
    return 0


def write_csi(path, recs, n_ref: int, bgzf: BgzfWriter, *,
              min_shift: int = 14, depth: int = 5) -> None:
    """CSI index (SAM spec 5.3; the reference's CSI variant,
    libkit4b/SAMfile.h:21-58): BGZF-compressed, per-reference bins with
    chunk lists and per-bin loffset; supports chromosomes beyond BAI's
    512 Mbp limit via configurable min_shift/depth."""
    per_ref: list[dict] = [dict() for _ in range(n_ref)]
    for ref_id, beg, end, u0, u1 in recs:
        v0 = bgzf.virtual_offset(u0)
        v1 = bgzf.virtual_offset(u1)
        b = _csi_reg2bin(beg, end, min_shift, depth)
        per_ref[ref_id].setdefault(b, []).append((v0, v1))
    payload = b"CSI\x01" + struct.pack("<iii", min_shift, depth, 0)
    payload += struct.pack("<i", n_ref)
    for bins in per_ref:
        merged = {}
        for b, chunks in bins.items():
            chunks.sort()
            out = [list(chunks[0])]
            for c0, c1 in chunks[1:]:
                if c0 == out[-1][1]:
                    out[-1][1] = c1
                else:
                    out.append([c0, c1])
            merged[b] = out
        payload += struct.pack("<i", len(merged))
        for b in sorted(merged):
            chunks = merged[b]
            loffset = chunks[0][0]
            payload += struct.pack("<IQi", b, loffset, len(chunks))
            for c0, c1 in chunks:
                payload += struct.pack("<QQ", c0, c1)
    w = BgzfWriter(path)
    w.write(payload)
    w.close()


def read_csi(path) -> dict:
    """Parse a CSI index back (tests / tooling)."""
    data = read_bgzf(path)
    assert data[:4] == b"CSI\x01"
    min_shift, depth, l_aux = struct.unpack_from("<iii", data, 4)
    off = 16 + l_aux
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, loffset, n_chunk = struct.unpack_from("<IQi", data, off)
            off += 16
            chunks = []
            for _ in range(n_chunk):
                c0, c1 = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((c0, c1))
            bins[b] = {"loffset": loffset, "chunks": chunks}
        refs.append(bins)
    return {"min_shift": min_shift, "depth": depth, "refs": refs}
