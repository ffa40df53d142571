"""Platform quality codec family (reference parity: codec_longr.c,
codec_pacb.c, codec_smux.c, codec_tmpl.c, codec_homp.c, codec_normq.c —
redesigned as SEQ-derived channel demux, codecs/qual.py)."""

import os

import numpy as np
import pytest

from genozip_tpu.utils import ragged
from genozip_tpu.utils.ragged import Col
from genozip_tpu.codecs import qual as qualmod
from genozip_tpu.codecs import compress, RANS1, ARITH1
from genozip_tpu.zip_pipeline import zip_file
from genozip_tpu.piz_pipeline import piz_file

RNG = np.random.default_rng(17)
ACGT = np.frombuffer(b"ACGT", np.uint8)


def synth_longread(n=3000, L=300):
    """Nanopore-like: QUAL correlated with position ramp + homopolymer
    interiors + noise."""
    seqs, quals = [], []
    for _ in range(n):
        seq = RNG.choice(ACGT, L)
        for _ in range(6):
            p = RNG.integers(0, L - 10)
            seq[p:p + RNG.integers(3, 9)] = seq[p]
        pos = np.arange(L)
        q = 20 + 14 * np.sin(np.minimum(pos, L - 1 - pos) / L * np.pi)
        hp = np.zeros(L)
        hp[1:] = seq[1:] == seq[:-1]
        q = np.clip(q - 8 * hp + RNG.normal(0, 2.5, L), 2, 40)
        seqs.append(seq.tobytes())
        quals.append((q.astype(np.uint8) + 33).tobytes())
    return Col.from_list(seqs), Col.from_list(quals)


def test_demux_remux_all_classes():
    seq, qual = synth_longread(400, 150)
    for cls in qualmod.CLASSES:
        g = qualmod.demux(cls, qual, seq)
        back = qualmod.remux(cls, g, seq, qual.lens)
        assert (back == qual.data).all(), cls


def test_demux_handles_seq_qual_len_mismatch():
    """SAM '*' SEQ rows: channels fall back to 'N' sequence."""
    seq = Col.from_list([b"ACGTACGT", b"*", b"GGGGCCCC"])
    qual = Col.from_list([b"IIIIFFFF", b"JJJ", b"::::####"])
    for cls in qualmod.CLASSES:
        g = qualmod.demux(cls, qual, seq)
        assert (qualmod.remux(cls, g, seq, qual.lens) == qual.data).all()


def test_orient_involutive():
    col = Col.from_list([b"ACGTT", b"GG", b"", b"TTTA"])
    rev = np.array([True, False, True, True])
    out = qualmod.orient(qualmod.orient(col, rev, comp=True), rev, comp=True)
    assert (out.data == col.data).all()
    one = qualmod.orient(col, rev, comp=True)
    assert one.row(0) == b"AACGT"  # revcomp of ACGTT
    assert one.row(1) == b"GG"


def test_qual_ratio_win_on_realistic_corpus():
    """Round-1 'done' bar: >=15% QUAL ratio win on a realistic
    (position+context-correlated) corpus vs plain order-1 coding."""
    seq, qual = synth_longread()
    base = len(compress(qual.data.tobytes(), RANS1))
    cls = qualmod.choose_class(seq, qual)
    assert cls is not None
    g = qualmod.demux(cls, qual, seq).tobytes()
    best = min(len(compress(g, RANS1)), len(compress(g, ARITH1)))
    assert best < base * 0.85, (cls, best, base)


def test_choose_class_declines_uniform_qual():
    seq = Col.from_list([RNG.choice(ACGT, 100).tobytes() for _ in range(200)])
    qual = Col.from_list([RNG.integers(35, 74, 100).astype(np.uint8).tobytes()
                          for _ in range(200)])
    assert qualmod.choose_class(seq, qual) is None


def test_fastq_roundtrip_with_demux(tmp_path):
    seq, qual = synth_longread(2000, 200)
    rows = []
    for i in range(len(seq)):
        rows.append(b"@r%d\n%s\n+\n%s\n" % (i, seq.row(i), qual.row(i)))
    data = b"".join(rows)
    src = os.path.join(str(tmp_path), "lr.fastq")
    open(src, "wb").write(data)
    z = src + ".gxz"
    zip_file(src, z)
    piz_file(z, src + ".out")
    assert open(src + ".out", "rb").read() == data
    # the demux must actually engage on this corpus
    from genozip_tpu.piz_pipeline import PizReader
    pr = PizReader(z)
    vb_hdr = pr.load_vb(1)[0]
    assert (vb_hdr["ctxs"]["QUAL"].get("special") or "").startswith("qdmx:")
    pr.close()


def test_sam_oq_t0_tags(tmp_path):
    """OQ:Z as byte-delta vs QUAL (codec_oq.c role) and T0:Z condensed per
    SEQ homopolymer run (codec_t0.c role), with misfitting exceptions."""
    rows = [b"@HD\tVN:1.6\n@SQ\tSN:c1\tLN:99999\n"]
    for i in range(400):
        L = 80
        seq = RNG.choice(ACGT, L)
        for _ in range(4):
            p = RNG.integers(0, L - 8)
            seq[p:p + RNG.integers(3, 7)] = seq[p]
        qual = RNG.integers(30, 40, L).astype(np.uint8) + 33
        oq = (qual + RNG.integers(-2, 3, L)).astype(np.uint8)
        runs = np.ones(L, bool)
        runs[1:] = seq[1:] != seq[:-1]
        rid = np.cumsum(runs) - 1
        t0 = RNG.choice(np.frombuffer(b"ABCDE", np.uint8),
                        int(rid[-1]) + 1)[rid]
        if i % 7 == 0:   # misfit T0 (wrong length) must fall to exceptions
            rows.append(b"q%d\t0\tc1\t%d\t60\t%dM\t*\t0\t0\t%s\t%s\t"
                        b"OQ:Z:%s\tt0:Z:XYZ\n"
                        % (i, 100 + i, L, seq.tobytes(), qual.tobytes(),
                           oq.tobytes()))
        else:
            rows.append(b"q%d\t0\tc1\t%d\t60\t%dM\t*\t0\t0\t%s\t%s\t"
                        b"OQ:Z:%s\tt0:Z:%s\n"
                        % (i, 100 + i, L, seq.tobytes(), qual.tobytes(),
                           oq.tobytes(), t0.tobytes()))
    data = b"".join(rows)
    src = os.path.join(str(tmp_path), "oqt0.sam")
    open(src, "wb").write(data)
    z = src + ".gxz"
    zip_file(src, z)
    piz_file(z, src + ".out")
    assert open(src + ".out", "rb").read() == data
    from genozip_tpu.piz_pipeline import PizReader
    pr = PizReader(z)
    hdr = pr.load_vb(1)[0]
    assert "AXOQZQ" in hdr["ctxs"], "OQ diff-vs-QUAL must engage"
    assert "AXt0ZH" in hdr["ctxs"], "T0 HP condensation must engage"
    pr.close()


def test_sam_roundtrip_strand_normalized(tmp_path):
    """Reverse-flag reads (codec_normq.c role): byte-exact with rev rows."""
    rows = [b"@HD\tVN:1.6\n@SQ\tSN:c1\tLN:99999\n"]
    seq, qual = synth_longread(800, 120)
    for i in range(len(seq)):
        fl = 16 if i % 3 == 0 else 0
        rows.append(b"r%d\t%d\tc1\t%d\t60\t120M\t*\t0\t0\t%s\t%s\n"
                    % (i, fl, 100 + i, seq.row(i), qual.row(i)))
    data = b"".join(rows)
    src = os.path.join(str(tmp_path), "rev.sam")
    open(src, "wb").write(data)
    z = src + ".gxz"
    zip_file(src, z)
    piz_file(z, src + ".out")
    assert open(src + ".out", "rb").read() == data


def test_bam_oq_t0_tags(tmp_path):
    """OQ:Z + t0:Z on the BINARY aux path (codec_oq.c / codec_t0.c roles
    for BAM inputs): byte-exact round-trip, and the transformed contexts
    must beat the tokenizer fallback >=2x on their own bytes."""
    import gzip
    import struct
    from genozip_tpu.zip_pipeline import zip_file
    from genozip_tpu.piz_pipeline import piz_file
    NIBOF = {65: 1, 67: 2, 71: 4, 84: 8}

    def rec(qname, pos, seq, qual_raw, aux):
        packed = bytearray((len(seq) + 1) // 2)
        for j, ch in enumerate(seq):
            packed[j // 2] |= NIBOF[ch] << (4 if j % 2 == 0 else 0)
        r = struct.pack("<iiBBHHHiiii", 0, pos, len(qname) + 1, 60, 4680,
                        1, 0, len(seq), -1, -1, 0)
        r += qname + b"\x00" + struct.pack("<I", (len(seq) << 4) | 0)
        r += bytes(packed) + bytes(qual_raw) + aux
        return struct.pack("<I", len(r)) + r

    def synth(oq_tag, t0_tag):
        hdr = b"@HD\tVN:1.6\n@SQ\tSN:c1\tLN:99999\n"
        out = [b"BAM\x01", struct.pack("<i", len(hdr)), hdr,
               struct.pack("<i", 1), struct.pack("<i", 3), b"c1\x00",
               struct.pack("<i", 99999)]
        # BQSR-style: OQ = original binned quals; QUAL = recalibration
        # table of OQ (near-deterministic per channel — what codec_oq.c's
        # 94 per-quality contexts exploit). Ultima-style t0: value is a
        # function of the homopolymer (run length, base) context.
        bins = np.array([2, 12, 23, 37], np.uint8)
        recal = (np.arange(94) * 7 % 40 + 2).astype(np.uint8)
        t0lut = ((np.arange(8 * 5) * 11) % 5 + ord("A")).astype(np.uint8)
        for i in range(500):
            L = 80
            seq = np.asarray(RNG.choice(ACGT, L))
            for _ in range(4):
                p = int(RNG.integers(0, L - 8))
                seq[p:p + int(RNG.integers(3, 7))] = seq[p]
            oq_raw = bins[RNG.integers(0, 4, L)]
            qual = recal[oq_raw].copy()
            noisy = RNG.random(L) < 0.05
            qual[noisy] = np.clip(qual[noisy] + 1, 0, 93)
            oq = (oq_raw + 33).astype(np.uint8)
            runs = np.ones(L, bool)
            runs[1:] = seq[1:] != seq[:-1]
            rid = np.cumsum(runs) - 1
            rl = np.bincount(rid)
            b5 = np.array([{65: 0, 67: 1, 71: 2, 84: 3}[c]
                           for c in seq[np.concatenate([[0],
                               np.nonzero(runs)[0][1:]])]])
            t0r = t0lut[np.minimum(rl, 7) * 5 + b5]
            flip = RNG.random(t0r.shape[0]) < 0.03
            t0r[flip] = ((t0r[flip] - ord("A") + 1) % 5) + ord("A")
            t0 = t0r[rid]
            aux = (oq_tag + b"Z" + oq.tobytes() + b"\x00"
                   + t0_tag + b"Z" + t0.tobytes() + b"\x00")
            out.append(rec(b"q%04d" % i, 100 + i, seq.tobytes(), qual, aux))
        return b"".join(out)

    sizes = {}
    for label, (oqt, t0t) in (("on", (b"OQ", b"t0")),
                              ("off", (b"OX", b"tX"))):
        raw = synth(oqt, t0t)
        src = os.path.join(str(tmp_path), f"oq_{label}.bam")
        with gzip.open(src, "wb") as f:
            f.write(raw)
        st = zip_file(src, src + ".gxz")
        piz_file(src + ".gxz", src + ".out")
        got = open(src + ".out", "rb").read()
        if got[:2] == b"\x1f\x8b":
            got = gzip.decompress(got)
        assert got == raw
        tag_z = sum(z for nm, (_u, z) in st.per_ctx.items()
                    if nm.startswith(("AXOQ", "AXt0", "AXOX", "AXtX")))
        sizes[label] = tag_z
    assert sizes["on"] * 2 <= sizes["off"], sizes
