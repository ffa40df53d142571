"""Deep: BAM+FASTQ co-compression — FASTQ reads matching BAM alignments store
only a reference to the alignment; SEQ/QUAL come from the BAM at PIZ.

Reference parity: src/deep.h (qname/seq/qual hash entries), src/sam_deep.c:208
sam_deep_zip_merge, src/fastq_deep.c:680 fastq_deep_seg_SEQ. Simplified
vectorized scheme: the index maps qname -> primary alignment (seq, qual,
orientation) built from raw BAM records with the same vectorized field
extraction as the BAM datatype; FASTQ matching is a dict lookup per read plus
whole-column vectorized byte comparison; PIZ rebuilds the index from the
reconstructed BAM component (which decompresses first), so the FASTQ
components carry only hit flags + residuals.
"""

import numpy as np

from .utils import ragged
from .utils.ragged import Col
from . import native

FLAG_REVCOMP = 16
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800
SEQ_NIBBLE = b"=ACMGRSVTWYHKDBN"


class DeepIndex:
    """qname -> row in (seq Col, qual Col, revcomp flags)."""

    def __init__(self):
        self.qname2row = {}
        self.seq_parts = []
        self.qual_parts = []
        self.rev_parts = []
        self._built = None

    def add_bam_records(self, records: bytes):
        data = np.frombuffer(records, np.uint8)
        offsets, consumed = native.bam_scan(data, 1 << 24)
        assert consumed == data.shape[0]
        off = offsets
        n = off.shape[0]
        if n == 0:
            return

        def u16(o):
            return data[o].astype(np.int64) | (data[o + 1].astype(np.int64) << 8)

        def u32(o):
            return (data[o].astype(np.int64) | (data[o + 1].astype(np.int64) << 8)
                    | (data[o + 2].astype(np.int64) << 16)
                    | (data[o + 3].astype(np.int64) << 24))

        l_rn = data[off + 12].astype(np.int64)
        n_cig = u16(off + 16)
        flag = u16(off + 18)
        l_seq = u32(off + 20)
        name = ragged.gather_ranges(data, off + 36, l_rn - 1)
        seq_start = off + 36 + l_rn + 4 * n_cig
        seq_bytes = (l_seq + 1) // 2
        qual_start = seq_start + seq_bytes

        # decode 4-bit SEQ to ASCII
        seq_col = ragged.gather_ranges(data, seq_start, seq_bytes)
        nib = np.frombuffer(SEQ_NIBBLE, np.uint8)
        expanded = np.empty(seq_col.data.shape[0] * 2, dtype=np.uint8)
        expanded[0::2] = nib[seq_col.data >> 4]
        expanded[1::2] = nib[seq_col.data & 15]
        seq_txt = ragged.gather_ranges(expanded, seq_col.offsets[:-1] * 2, l_seq)
        qual_col = ragged.gather_ranges(data, qual_start, l_seq)
        qual_txt = Col((qual_col.data + 33).astype(np.uint8), qual_col.offsets)

        primary = (flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)) == 0
        base = self._row_count()
        rows = np.nonzero(primary & (l_seq > 0))[0]
        sub_seq = ragged.take(seq_txt, rows)
        sub_qual = ragged.take(qual_txt, rows)
        sub_rev = ((flag[rows] & FLAG_REVCOMP) != 0)
        for j, r in enumerate(rows):
            q = name.row(int(r))
            if q not in self.qname2row:
                self.qname2row[q] = base + j
        self.seq_parts.append(sub_seq)
        self.qual_parts.append(sub_qual)
        self.rev_parts.append(sub_rev)
        self._built = None

    def _row_count(self):
        return sum(len(p) for p in self.seq_parts)

    def _build(self):
        if self._built is None:
            def cat(parts):
                if not parts:
                    return Col.from_list([])
                data = np.concatenate([p.data for p in parts])
                lens = np.concatenate([p.lens for p in parts])
                return Col(data, np.concatenate([[0], np.cumsum(lens)]))
            self._built = (cat(self.seq_parts), cat(self.qual_parts),
                           np.concatenate(self.rev_parts) if self.rev_parts
                           else np.zeros(0, bool))
        return self._built

    def lookup_rows(self, desc_col: Col) -> np.ndarray:
        """qname per FASTQ desc row -> index row (or -1). Strips '@', takes
        the first whitespace token, tries with and without /1 /2 suffix."""
        n = len(desc_col)
        out = np.full(n, -1, dtype=np.int64)
        q2r = self.qname2row
        for i in range(n):
            d = desc_col.row(i)
            if d[:1] == b"@":
                d = d[1:]
            sp = d.find(b" ")
            if sp >= 0:
                d = d[:sp]
            r = q2r.get(d)
            if r is None and len(d) > 2 and d[-2:-1] == b"/":
                r = q2r.get(d[:-2])
            out[i] = -1 if r is None else r
        return out

    def fetch(self, rows: np.ndarray):
        """Returns (seq Col, qual Col) for index rows, in FASTQ orientation
        (reverse-complemented back when the alignment was revcomp)."""
        seq, qual, rev = self._build()
        s = ragged.take(seq, rows)
        q = ragged.take(qual, rows)
        rrev = rev[rows]
        if rrev.any():
            ridx = np.nonzero(rrev)[0]
            sub = ragged.take(s, ridx)
            mat, lens = ragged.to_matrix(sub)
            from .ref.aligner import _rev_seq
            rmat = _rev_seq(mat, lens)
            fixed = ragged.from_matrix(rmat, lens)
            s = ragged.merge_rows(len(s), [
                (np.nonzero(~rrev)[0], ragged.take(s, np.nonzero(~rrev)[0])),
                (ridx, fixed)])
            qsub = ragged.take(q, ridx)
            qmat, qlens = ragged.to_matrix(qsub)
            qrev = np.take_along_axis(
                qmat, np.clip(qlens[:, None] - 1 - np.arange(qmat.shape[1])[None, :],
                              0, qmat.shape[1] - 1), axis=1)
            q = ragged.merge_rows(len(q), [
                (np.nonzero(~rrev)[0], ragged.take(q, np.nonzero(~rrev)[0])),
                (ridx, ragged.from_matrix(qrev, qlens))])
        return s, q


def cols_equal_rows(a: Col, b: Col) -> np.ndarray:
    """Per-row equality of two same-length columns, vectorized."""
    n = len(a)
    eq_len = a.lens == b.lens
    out = np.zeros(n, dtype=bool)
    idx = np.nonzero(eq_len)[0]
    if idx.shape[0] == 0:
        return out
    sa = ragged.take(a, idx)
    sb = ragged.take(b, idx)
    neq = sa.data != sb.data
    # rows with zero mismatching bytes
    row_of = np.searchsorted(sa.offsets[1:], np.nonzero(neq)[0], side="right")
    bad = np.zeros(idx.shape[0], dtype=bool)
    bad[row_of] = True
    out[idx[~bad]] = True
    return out
