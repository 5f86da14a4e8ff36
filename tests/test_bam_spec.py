"""External BAM validation (VERDICT r2 weak #5 / next-8): decode the
writer's output with an INDEPENDENT from-spec implementation.

tests/test_bam.py round-trips through io/bam.read_bam, which lives next
to the writer and shares its constants — a shared encode/decode bug
would pass. The decoder below is written directly from the SAMv1 spec
(sections 4.1 BGZF, 4.2 BAM, 5.3 binning) and imports NOTHING from
mapcaller.io.bam:

  * BGZF parsed at the gzip-member level (FEXTRA + "BC" subfield with
    BSIZE, raw-deflate payload, per-block CRC32 + ISIZE verified, the
    exact 28-byte EOF marker required — htslib refuses files without
    it)
  * BAM records decoded with fresh spec tables and re-rendered as SAM
    text lines, compared to the SAM lines the same run produced
  * per-record bin field checked against a fresh reg2bin transcription
    of the spec's C code
"""
import os
import struct
import zlib

import pytest

from mapcaller.config import Config
from mapcaller.index.fmindex import build_index
from mapcaller.io.sam import sam_headers
from mapcaller.pipeline.engine import MappingEngine
from mapcaller.pipeline.read import ReadState

DATA = os.path.join(os.path.dirname(__file__), "data", "subset")

# ---- independent from-spec decoder (no mapcaller.io.bam) ----------

SPEC_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
SPEC_SEQ = "=ACMGRSVTWYHKDBN"          # spec 4.2.3
SPEC_CIG = "MIDNSHP=X"                 # spec 4.2.2


def spec_reg2bin(beg, end):
    """Direct transcription of SAMv1 spec section 5.3 C code."""
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


def spec_bgzf_decompress(path):
    """Parse BGZF members per spec 4.1, verifying structure per block.
    Returns the concatenated uncompressed stream."""
    raw = open(path, "rb").read()
    assert raw.endswith(SPEC_EOF), "missing/damaged BGZF EOF marker"
    out = bytearray()
    off = 0
    n_blocks = 0
    while off < len(raw):
        assert raw[off:off + 2] == b"\x1f\x8b", f"bad gzip magic @{off}"
        cm, flg = raw[off + 2], raw[off + 3]
        assert cm == 8 and (flg & 4), "BGZF requires CM=deflate, FEXTRA"
        (xlen,) = struct.unpack_from("<H", raw, off + 10)
        xoff, xend = off + 12, off + 12 + xlen
        bsize = None
        while xoff < xend:              # walk extra subfields
            si1, si2 = raw[xoff], raw[xoff + 1]
            (slen,) = struct.unpack_from("<H", raw, xoff + 2)
            if (si1, si2) == (ord("B"), ord("C")):
                assert slen == 2
                (bsize,) = struct.unpack_from("<H", raw, xoff + 4)
                bsize += 1
            xoff += 4 + slen
        assert bsize is not None, "BGZF block without BC subfield"
        cdata = raw[xend:off + bsize - 8]
        crc, isize = struct.unpack_from("<II", raw, off + bsize - 8)
        payload = zlib.decompress(cdata, -15)
        assert zlib.crc32(payload) & 0xFFFFFFFF == crc, "block CRC"
        assert len(payload) == isize, "block ISIZE"
        assert len(payload) <= 0x10000, "payload over 64 KiB"
        out += payload
        off += bsize
        n_blocks += 1
    assert n_blocks >= 2                # data + EOF marker at minimum
    return bytes(out)


def spec_decode_bam(stream):
    """BAM binary -> (header_text, [(name, length)], [sam_line_strs])
    straight from spec 4.2."""
    assert stream[:4] == b"BAM\x01"
    off = 4
    (l_text,) = struct.unpack_from("<i", stream, off); off += 4
    text = stream[off:off + l_text].decode(); off += l_text
    (n_ref,) = struct.unpack_from("<i", stream, off); off += 4
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", stream, off); off += 4
        name = stream[off:off + l_name - 1].decode(); off += l_name
        (l_ref,) = struct.unpack_from("<i", stream, off); off += 4
        refs.append((name, l_ref))
    lines = []
    while off < len(stream):
        (block_size,) = struct.unpack_from("<i", stream, off); off += 4
        end = off + block_size
        (ref_id, pos, l_read_name, mapq, bam_bin, n_cigar_op, flag,
         l_seq, next_ref_id, next_pos, tlen) = struct.unpack_from(
            "<iiBBHHHiiii", stream, off)
        off += 32
        read_name = stream[off:off + l_read_name - 1].decode()
        off += l_read_name
        cig = struct.unpack_from(f"<{n_cigar_op}I", stream, off)
        off += 4 * n_cigar_op
        cigar = "".join(f"{c >> 4}{SPEC_CIG[c & 15]}" for c in cig) or "*"
        seq = []
        for i in range(l_seq):
            b = stream[off + (i >> 1)]
            seq.append(SPEC_SEQ[(b >> 4) if i % 2 == 0 else (b & 15)])
        off += (l_seq + 1) // 2
        qarr = stream[off:off + l_seq]; off += l_seq
        qual = ("*" if not l_seq or qarr[0] == 0xFF
                else "".join(chr(q + 33) for q in qarr))
        # verify the bin field against the spec formula
        if pos >= 0:
            span = sum(c >> 4 for c in cig if SPEC_CIG[c & 15] in "MDN=X")
            assert bam_bin == spec_reg2bin(pos, pos + (span or 1)), \
                (read_name, bam_bin)
        tags = []
        while off < end:
            tag = stream[off:off + 2].decode()
            typ = chr(stream[off + 2]); off += 3
            if typ in "cCsSiI":
                fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H",
                       "i": "<i", "I": "<I"}[typ]
                (v,) = struct.unpack_from(fmt, stream, off)
                off += struct.calcsize(fmt)
                tags.append(f"{tag}:i:{v}")
            elif typ == "A":
                tags.append(f"{tag}:A:{chr(stream[off])}"); off += 1
            elif typ == "f":
                (v,) = struct.unpack_from("<f", stream, off); off += 4
                tags.append(f"{tag}:f:{v:g}")
            elif typ == "Z":
                z = stream.index(b"\0", off)
                tags.append(f"{tag}:Z:{stream[off:z].decode()}")
                off = z + 1
            else:
                raise AssertionError(f"unexpected tag type {typ}")
        assert off == end, read_name
        rname = refs[ref_id][0] if ref_id >= 0 else "*"
        if next_ref_id < 0:
            rnext = "*"
        elif next_ref_id == ref_id:
            rnext = "="
        else:
            rnext = refs[next_ref_id][0]
        lines.append("\t".join(
            [read_name, str(flag), rname, str(pos + 1), str(mapq), cigar,
             rnext, str(next_pos + 1), str(tlen),
             "".join(seq) if l_seq else "*", qual] + tags))
    return text, refs, lines


# ---- the test ---------------------------------------------------------

def test_bam_decodes_identically_with_from_spec_reader(toy_fasta, tmp_path):
    from mapcaller.io.bam import BamWriter
    from mapcaller.io.fastq import iter_chunks

    idx = build_index(toy_fasta)
    cfg = Config(bam_file=str(tmp_path / "o.bam"), vcf_output=False)
    engine = MappingEngine(idx, cfg)
    headers = sam_headers(engine.genome, "0.9.9.41")
    writer = BamWriter(cfg.bam_file, engine.genome, headers)
    sam_lines = []
    for chunk in iter_chunks(os.path.join(DATA, "sub_r1.fq.gz"),
                             os.path.join(DATA, "sub_r2.fq.gz")):
        reads = [ReadState(r.header, r.seq, r.qual) for r in chunk]
        for line in engine.process_chunk(reads, True):
            sam_lines.append(line)
            writer.write_sam_line(line)
    writer.close()
    assert len(sam_lines) >= 400

    stream = spec_bgzf_decompress(cfg.bam_file)
    text, refs, got_lines = spec_decode_bam(stream)
    assert text.splitlines() == headers
    assert [r[0] for r in refs] == list(engine.genome.names)
    assert [int(r[1]) for r in refs] == [int(x) for x in
                                         engine.genome.lengths]
    assert len(got_lines) == len(sam_lines)
    for want, got in zip(sam_lines, got_lines):
        # the i-tag width letter is canonicalized to 'i' both sides;
        # everything else must match byte for byte
        assert got == want.rstrip("\n"), (got, want)
