#!/usr/bin/env python
"""Benchmark driver hook: prints ONE JSON line
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}.

Primary metric: end-to-end FASTQ compression MB/s (the reference's headline
workload). Extras carry the full five-config table from BASELINE.json —
  cfg1 small multi-sample VCF (AD/PL/GQ samples + VEP-style CSQ INFO)
  cfg2 FASTA reference (ACGT 2-bit pack + entropy path)
  cfg3 single-end FASTQ, reference-less
  cfg4 paired FASTQ vs reference (seed-hash aligner path)
  cfg5 sorted WGS-style BAM with secondary/supplementary (gencomp/SAG path)
plus a long-read minimap2-style SAM — each with MB/s, ratio, and
ratio-vs-xz6 / ratio-vs-bz2 (bsc-class BWT proxy) alongside, since the
reference binary cannot run unlicensed in this zero-egress image (README
has the full story).
"""

import json
import os
import time

BDIR = "/tmp/gxz_bench4"   # corpus v2 (adversarial: repeat-family genome,
                           # mixed qname flavors, annotator-soup VCF,
                           # primary+supplementary qname pairs in BAM)
BENCH_MB = int(os.environ.get("GXZ_BENCH_MB", "48"))
SIDE_MB = int(os.environ.get("GXZ_BENCH_SIDE_MB", "24"))
BASELINE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "BENCH_BASELINE.json")


def _genome(rng, n=4 << 20):
    """Corpus-v2 genome: iid base + interspersed repeat families (~10%
    density, mutated ~300bp prototypes — Alu/LINE stand-ins that stress
    refhash collision policy and aligner best-match scoring) + tandem
    repeats + homopolymer runs."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", np.uint8)
    g = rng.choice(bases, n)
    fams = [rng.choice(bases, int(rng.integers(200, 400)))
            for _ in range(6)]
    budget = n // 10
    while budget > 0:
        proto = fams[int(rng.integers(0, len(fams)))]
        L = proto.shape[0]
        p = int(rng.integers(0, n - L))
        copy = proto.copy()
        k = int(rng.binomial(L, 0.02))
        if k:
            mp = rng.integers(0, L, k)
            copy[mp] = bases[rng.integers(0, 4, k)]
        g[p:p + L] = copy
        budget -= L
    for _ in range(n // 20000):   # tandem repeats, unit 2-40bp
        u = int(rng.integers(2, 40))
        reps = int(rng.integers(5, 40))
        unit = rng.choice(bases, u)
        p = int(rng.integers(0, n - u * reps))
        g[p:p + u * reps] = np.tile(unit, reps)
    for _ in range(n // 2000):    # homopolymer runs
        p = int(rng.integers(0, n - 40))
        g[p:p + int(rng.integers(5, 30))] = g[p]
    return g


def _qual_rows(rng, n, rl):
    """Illumina-RTA3-style binned quality with a positional ramp."""
    import numpy as np
    pos = np.arange(rl)
    base = 36.0 - 8.0 * (pos / rl) ** 2 - 2.0 * (pos < 3)
    q = base[None, :] + rng.normal(0, 3.0, (n, rl))
    bins = np.array([2, 12, 23, 37])
    idx = np.abs(q[:, :, None] - bins[None, None, :]).argmin(axis=2)
    return (bins[idx] + 33).astype(np.uint8)


def _read_from(rng, genome, pos, rl, err=0.003, rev=False):
    import numpy as np
    from genozip_tpu.ops import pack as packops
    seq = genome[pos:pos + rl].copy()
    ne = rng.binomial(rl, err)
    if ne:
        mp = rng.integers(0, rl, ne)
        seq[mp] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, ne)]
    if rev:
        seq = packops.ACGT[packops.BASE2BIT[seq] ^ 3][::-1]
    return seq, int(ne)


def gen_fastq(path, target_mb, rng, genome):
    import numpy as np
    target = target_mb << 20
    size = 0
    i = 0
    rl = 150
    G = genome.shape[0]
    from genozip_tpu.ops import pack as packops
    with open(path, "wb") as f:
        while size < target:
            n = 20000
            starts = rng.integers(0, G - rl, n)
            mat = genome[starts[:, None] + np.arange(rl)[None, :]].copy()
            nerr = rng.binomial(n * rl, 0.003)
            er, ec = rng.integers(0, n, nerr), rng.integers(0, rl, nerr)
            mat[er, ec] = np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, nerr)]
            rev = rng.random(n) < 0.5
            rc = packops.BASE2BIT[mat] ^ 3
            mat[rev] = packops.ACGT[rc[rev][:, ::-1]]
            quals = _qual_rows(rng, n, rl)
            # mixed qname flavors PER BLOCK (corpus v2: real archives see
            # flavor drift — Illumina, BGI fixed-width zero-padded, NCBI
            # SRR with length=, ONT uuid-ish; qname_flavors.h coverage)
            flavor = i % 4
            if flavor == 0:
                nm = lambda r: b"@SIM:1:FC706VJ:1:%d:%d:%d 1:N:0:ATCACG" % (
                    2100 + r // 100000, 15000 + r % 90000,
                    1000 + (r * 7) % 90000)
            elif flavor == 1:
                nm = lambda r: b"@E100016873L1C%03dR%03d%07d" % (
                    r // 10000 % 999 + 1, r // 100 % 999 + 1, r % 9999999)
            elif flavor == 2:
                nm = lambda r: b"@SRR8861483.%d %d length=150" % (r + 1, r + 1)
            else:
                nm = lambda r: b"@%08x-%04x-%04x-%04x-%012x" % (
                    r * 2654435761 % (1 << 32), r % (1 << 16),
                    (r * 7) % (1 << 16), (r * 13) % (1 << 16),
                    r * 1099511627 % (1 << 48))
            body = b"".join(
                b"%s\n%s\n+\n%s\n"
                % (nm(i * n + j), mat[j].tobytes(), quals[j].tobytes())
                for j in range(n))
            f.write(body)
            size += len(body)
            i += 1
    return size


def gen_fasta(path, rng, genome):
    """The genome as a FASTA (config 2: ACGT pack + entropy round-trip)."""
    import numpy as np
    G = genome.shape[0]
    with open(path, "wb") as f:
        f.write(b">chrB test benchmark contig\n")
        rows = genome[: G - G % 60].reshape(-1, 60)
        block = np.empty((rows.shape[0], 61), np.uint8)
        block[:, :60] = rows
        block[:, 60] = ord("\n")
        f.write(block.tobytes())
        tail = genome[G - G % 60:]
        if tail.shape[0]:
            f.write(tail.tobytes() + b"\n")
    return os.path.getsize(path)


def gen_paired_fastq(p1, p2, target_mb, rng, genome):
    """Proper pairs: R1 fwd at p, R2 revcomp at p+~250 (config 4 aligner)."""
    import numpy as np
    target = target_mb << 20
    rl = 150
    G = genome.shape[0]
    size = 0
    i = 0
    f1, f2 = open(p1, "wb"), open(p2, "wb")
    while size < 2 * target:
        n = 10000
        starts = rng.integers(0, G - rl - 400, n)
        gaps = rng.integers(150, 350, n)
        q1 = _qual_rows(rng, n, rl)
        q2 = _qual_rows(rng, n, rl)
        b1, b2 = [], []
        for j in range(n):
            p = int(starts[j])
            s1, _ = _read_from(rng, genome, p, rl)
            s2, _ = _read_from(rng, genome, p + int(gaps[j]), rl, rev=True)
            nm = b"@SIM:2:FCPAIR:1:%d:%d:%d" % (
                2100 + (i * n + j) // 100000, 15000 + (i * n + j) % 90000,
                1000 + ((i * n + j) * 7) % 90000)
            b1.append(b"%s/1\n%s\n+\n%s\n" % (nm, s1.tobytes(),
                                              q1[j].tobytes()))
            b2.append(b"%s/2\n%s\n+\n%s\n" % (nm, s2.tobytes(),
                                              q2[j].tobytes()))
        c1, c2 = b"".join(b1), b"".join(b2)
        f1.write(c1)
        f2.write(c2)
        size += len(c1) + len(c2)
        i += 1
    f1.close()
    f2.close()
    return size


def gen_bam(path, target_mb, rng, genome):
    """Coordinate-sorted BAM at ~7x coverage with BWA-style tags (NM/AS/XS,
    XA on multi-mappers) plus ~8% secondary and ~4% supplementary
    alignments with SA:Z (the gencomp/SAG path, reference sections.h:32)."""
    import numpy as np
    from genozip_tpu.translate import sam_header_to_bam, sam_vb_to_bam
    from genozip_tpu.utils.bgzf import BgzfWriter
    G = genome.shape[0]
    rl = 150
    n_chrom = max(1, target_mb * (1 << 20) // (G * 5 // 4) + 1)
    hdr = b"@HD\tVN:1.6\tSO:coordinate\n" + b"".join(
        b"@SQ\tSN:chr%d\tLN:%d\n" % (c + 1, G) for c in range(n_chrom))
    bam_hdr, name2id = sam_header_to_bam(hdr)
    f = open(path, "wb")
    w = BgzfWriter(f)
    w.write(bam_hdr)
    target = target_mb << 20
    rid = 0
    for c in range(n_chrom):
        if f.tell() >= target:
            break
        chrom = b"chr%d" % (c + 1)
        pos = 1
        while pos < G - 2 * rl and f.tell() < target:
            n = 60000
            hi = min(pos + 2_000_000, G - rl)
            poss = np.sort(rng.integers(pos, hi, n))
            nerr = rng.binomial(rl, 0.003, n)
            quals = _qual_rows(rng, n, rl)
            kinds = rng.random(n)
            rows = []
            for j in range(n):
                p = int(poss[j])
                seq, _ = _read_from(rng, genome, p, rl)
                ne = int(nerr[j])
                as_v = rl - 2 * ne
                name = b"b%d" % (rid + j)
                if kinds[j] < 0.08:
                    # multi-mapper (corpus v2): primary + secondary record
                    # SHARING the qname (real BWA output — the prescan
                    # deports the primary so the secondary compresses
                    # against it, sections.h:32 SAG semantics)
                    p2 = int(rng.integers(0, G - rl))
                    rows.append(
                        b"%s\t0\t%s\t%d\t60\t%dM\t*\t0\t0\t%s\t%s\t"
                        b"NM:i:%d\tAS:i:%d\tXA:Z:%s,+%d,%dM,%d;\n"
                        % (name, chrom, p + 1, rl, seq.tobytes(),
                           quals[j].tobytes(), ne, as_v,
                           chrom, p2 + 1, rl, ne + 1))
                    rows.append(
                        b"%s\t256\t%s\t%d\t0\t%dM\t*\t0\t0\t*\t*\t"
                        b"NM:i:%d\tAS:i:%d\n"
                        % (name, chrom, p2 + 1, rl, ne + 1, as_v - 5))
                elif kinds[j] < 0.12:
                    # split read (corpus v2): primary (75M75S, SA -> supp)
                    # + supplementary (75H75M, SA -> primary) whose SEQ and
                    # QUAL are the hard-clip slice of the primary — the
                    # full SAG elision path (sam_sag_ingest.c)
                    half = rl // 2
                    rows.append(
                        b"%s\t0\t%s\t%d\t60\t%dM%dS\t*\t0\t0\t%s\t%s\t"
                        b"NM:i:%d\tSA:Z:%s,%d,+,%dH%dM,60,%d;\n"
                        % (name, chrom, p + 1, half, rl - half,
                           seq.tobytes(), quals[j].tobytes(), ne,
                           chrom, p + 401, half, rl - half, ne))
                    rows.append(
                        b"%s\t2048\t%s\t%d\t60\t%dH%dM\t*\t0\t0\t%s\t%s\t"
                        b"NM:i:%d\tSA:Z:%s,%d,+,%dM%dS,60,%d;\n"
                        % (name, chrom, p + 401, half, rl - half,
                           seq[half:].tobytes(), quals[j][half:].tobytes(),
                           ne, chrom, p + 1, half, rl - half, ne))
                else:
                    fl = 99 if j % 2 == 0 else 147
                    xa = b""
                    if kinds[j] > 0.9:
                        p2 = int(rng.integers(0, G - rl))
                        xa = b"\tXA:Z:%s,-%d,%dM,%d;" % (
                            chrom, p2 + 1, rl, ne + 1)
                    rows.append(
                        b"%s\t%d\t%s\t%d\t60\t%dM\t=\t%d\t%d\t%s\t%s\t"
                        b"NM:i:%d\tAS:i:%d\tXS:i:%d%s\n"
                        % (name, fl, chrom, p + 1, rl, p + 200,
                           350 if fl == 99 else -350, seq.tobytes(),
                           quals[j].tobytes(), ne, as_v,
                           as_v - int(rng.integers(5, 30)), xa))
            rid += n
            blob, lens, *_ = sam_vb_to_bam(b"".join(rows), name2id)
            w.write(blob)
            pos = hi
    w.close()
    return os.path.getsize(path)


def gen_longread_sam(path, target_mb, rng, genome):
    """Long-read minimap2-style SAM: 3-20kb reads, indel-rich CIGARs,
    ms/s1/de/tp/cm tags (reference src/sam_minimap2.c shapes)."""
    import numpy as np
    G = genome.shape[0]
    target = target_mb << 20
    hdr = b"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chrB\tLN:%d\n" % G
    size = len(hdr)
    i = 0
    with open(path, "wb") as f:
        f.write(hdr)
        pos = 1
        while size < target and pos < G - 25000:
            rl = int(rng.integers(3000, 20000))
            pos += int(rng.integers(100, 2000))
            if pos + rl + 100 >= G:
                break
            # indel-rich cigar FIRST; SEQ then follows it (M from genome
            # with errors, I random, D skips genome) so the archive's
            # SEQ-vs-ref path sees realistic ~2% divergence
            bases = np.frombuffer(b"ACGT", np.uint8)
            cig = []
            pieces = []
            left = rl
            gp = pos
            ne = 0
            while left > 0:
                m = min(left, int(rng.integers(500, 3000)))
                cig.append(b"%dM" % m)
                chunk = genome[gp:gp + m].copy()
                k = rng.binomial(m, 0.02)
                if k:
                    mp = rng.integers(0, m, k)
                    chunk[mp] = bases[rng.integers(0, 4, k)]
                    ne += k
                pieces.append(chunk)
                gp += m
                left -= m
                if left > 10 and rng.random() < 0.6:
                    ind = int(rng.integers(1, 8))
                    if rng.random() < 0.5:
                        cig.append(b"%dI" % ind)
                        pieces.append(bases[rng.integers(0, 4, ind)])
                        left -= ind
                        ne += ind
                    else:
                        cig.append(b"%dD" % ind)
                        gp += ind
                        ne += ind
            seq = np.concatenate(pieces)
            rl = seq.shape[0]
            # ONT-ish qual: correlated random walk over a small alphabet
            q = np.clip(np.cumsum(rng.integers(-2, 3, rl)) % 25 + 5,
                        2, 40).astype(np.uint8) + 33
            as_v = rl - 6 * int(ne)
            row = (b"lr%d\t0\tchrB\t%d\t60\t%s\t*\t0\t0\t%s\t%s\t"
                   b"NM:i:%d\tms:i:%d\tAS:i:%d\tnn:i:0\ttp:A:P\tcm:i:%d\t"
                   b"s1:i:%d\ts2:i:%d\tde:f:0.%04d\trl:i:0\n"
                   % (i, pos + 1, b"".join(cig), seq.tobytes(), q.tobytes(),
                      ne, as_v - 2, as_v, rl // 19, as_v // 2,
                      int(rng.integers(0, as_v // 2 + 1)),
                      int(rng.integers(100, 700))))
            f.write(row)
            size += len(row)
            i += 1
    return size


def gen_vcf(path, target_mb, rng):
    """Multi-sample VCF: GT:AD:DP:GQ:PL samples + VEP-style CSQ INFO
    (annotator depth: AD/PL cross-tag predictions + structured
    CSQ must have real material to work on)."""
    import numpy as np
    nsamp = 200
    names = "\t".join(f"S{i:04d}" for i in range(nsamp))
    genes = [b"GENE%04d" % i for i in range(700)]
    cons = [b"missense_variant", b"synonymous_variant", b"stop_gained",
            b"intron_variant", b"3_prime_UTR_variant"]
    aas = [b"Ala", b"Val", b"Gly", b"Ser", b"Leu", b"Thr"]
    hdr = ("##fileformat=VCFv4.2\n##contig=<ID=chr1,length=100000000>\n"
           "##FORMAT=<ID=GT,Number=1,Type=String>\n"
           "##FORMAT=<ID=AD,Number=R,Type=Integer>\n"
           "##FORMAT=<ID=DP,Number=1,Type=Integer>\n"
           "##FORMAT=<ID=GQ,Number=1,Type=Integer>\n"
           "##FORMAT=<ID=PL,Number=G,Type=Integer>\n"
           "##INFO=<ID=AF,Number=A,Type=Float>\n"
           "##INFO=<ID=AC,Number=A,Type=Integer>\n"
           "##INFO=<ID=AN,Number=1,Type=Integer>\n"
           "##INFO=<ID=DP,Number=1,Type=Integer>\n"
           "##INFO=<ID=BaseQRankSum,Number=1,Type=Float>\n"
           "##INFO=<ID=ExcessHet,Number=1,Type=Float>\n"
           "##INFO=<ID=FS,Number=1,Type=Float>\n"
           "##INFO=<ID=MQ,Number=1,Type=Float>\n"
           "##INFO=<ID=MQRankSum,Number=1,Type=Float>\n"
           "##INFO=<ID=QD,Number=1,Type=Float>\n"
           "##INFO=<ID=ReadPosRankSum,Number=1,Type=Float>\n"
           "##INFO=<ID=SOR,Number=1,Type=Float>\n"
           '##INFO=<ID=CSQ,Number=.,Type=String,Description="VEP">\n'
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
           + names + "\n").encode()
    target = target_mb << 20
    size = len(hdr)
    pos = 10000
    ACGT = [b"A", b"C", b"G", b"T"]
    with open(path, "wb") as f:
        f.write(hdr)
        while size < target:
            n = 200
            rows = []
            for _ in range(n):
                pos += int(rng.integers(50, 3000))
                ref, alt = rng.choice(ACGT, 2, replace=False)
                af = rng.random() * 0.5
                probs = [(1 - af) ** 2, 2 * af * (1 - af), af ** 2, 0.002]
                probs = np.array(probs) / sum(probs)
                g = rng.choice(4, nsamp, p=probs)
                dp = rng.poisson(30, nsamp)
                ad_alt = np.where(g == 1, dp // 2, np.where(g == 2, dp, 0))
                gts = [b"0/0", b"0/1", b"1/1", b"./."]
                cells = []
                for gi, d, aa in zip(g, dp, ad_alt):
                    adr = int(d) - int(aa)
                    pl = {0: (0, int(3 * d), int(30 + 3 * d)),
                          1: (int(3 * aa), 0, int(3 * adr)),
                          2: (int(30 + 3 * d), int(3 * d), 0),
                          3: (0, 0, 0)}[int(gi)]
                    gq = min(sorted(pl)[1] - sorted(pl)[0] + 2, 99)
                    cells.append(b"%s:%d,%d:%d:%d:%d,%d,%d" % (
                        gts[int(gi)], adr, int(aa), int(d), gq, *pl))
                trs = []
                for _t in range(int(rng.integers(1, 4))):
                    cdna = int(rng.integers(1, 9000))
                    trs.append(b"|".join([
                        alt, cons[int(rng.integers(0, 5))],
                        genes[int(rng.integers(0, 700))],
                        b"ENST%011d" % rng.integers(1, 3e5),
                        b"c.%d%s>%s" % (cdna, ref, alt),
                        b"p.%s%d%s" % (aas[int(rng.integers(0, 6))],
                                       cdna // 3,
                                       aas[int(rng.integers(0, 6))]),
                        b"0.%04d" % rng.integers(0, 9999)]))
                # GATK-style annotator soup (corpus v2): AC/AN/AF with the
                # AC == round(AN*AF) relation holding on most rows, plus
                # mixed-precision float annotations (vcf_gatk.c material)
                miss = int((g == 3).sum())
                an = 2 * (nsamp - miss)
                ac = int((g == 1).sum() + 2 * (g == 2).sum())
                af2 = round(ac / max(an, 1), 4)
                soup = (b"AC=%d;AN=%d;BaseQRankSum=%.3f;ExcessHet=%.4f;"
                        b"FS=%.3f;MQ=%.2f;MQRankSum=%.3f;QD=%.2f;"
                        b"ReadPosRankSum=%.3f;SOR=%.3f"
                        % (ac, an, rng.normal(0, 1), 3.0103,
                           abs(rng.normal(2, 2)), 60 - abs(rng.normal(0, 1)),
                           rng.normal(0, 0.5), abs(rng.normal(15, 5)),
                           rng.normal(0, 0.7), abs(rng.normal(0.7, 0.3))))
                rows.append(b"chr1\t%d\trs%d\t%s\t%s\t%d\tPASS\t"
                            b"AF=%.4f;%s;DP=%d;CSQ=%s\tGT:AD:DP:GQ:PL\t%s\n"
                            % (pos, pos, ref, alt, 30 + pos % 60, af2,
                               soup, int(dp.sum()), b",".join(trs),
                               b"\t".join(cells)))
            body = b"".join(rows)
            f.write(body)
            size += len(body)
    return size


def bench_zip(path, runs=1, **zip_kw):
    from genozip_tpu.zip_pipeline import zip_file
    z = path + ".gxz"
    best = None
    txt_inner = None
    for _ in range(runs):
        t0 = time.time()
        st = zip_file(path, z, **zip_kw)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
        txt_inner = getattr(st, "txt_len", None)
    txt = os.path.getsize(path)
    # disk-size basis MB/s + ratio; for compressed inputs (BAM/gz) also the
    # txt (inner/uncompressed) basis — the reference's progress counts txt
    extra = (txt_inner / 1e6 / best) if txt_inner and txt_inner > txt * 1.5 \
        else None
    return txt / 1e6 / best, txt / os.path.getsize(z), extra


def bench_piz(path, runs=2, reference=None):
    """Decompression throughput (txt-bytes basis) of the archive that
    bench_zip just wrote."""
    from genozip_tpu.piz_pipeline import piz_file
    z = path + ".gxz"
    out = path + ".piz_out"
    best = None
    for _ in range(runs):
        t0 = time.time()
        piz_file(z, out, reference=reference)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    sz = os.path.getsize(out)
    os.remove(out)
    return sz / 1e6 / best


def proxy_ratios(path, cap=1 << 30):
    # WHOLE-file proxies: a positional cap lies when content varies along
    # the file (corpus v2 alternates qname flavors by block)
    import zlib
    import bz2
    import lzma
    data = open(path, "rb").read(cap)
    gz = len(zlib.compress(data, 6))
    xz = len(lzma.compress(data, preset=6))
    bz = len(bz2.compress(data, 9))
    return len(data) / gz, len(data) / xz, len(data) / bz


def main():
    import numpy as np
    os.makedirs(BDIR, exist_ok=True)
    rng = np.random.default_rng(2024)
    genome = _genome(rng)

    fq = os.path.join(BDIR, "bench.fastq")
    if not os.path.exists(fq):
        gen_fastq(fq, BENCH_MB, rng, genome)
    big_genome = None
    fa = os.path.join(BDIR, "bench.fa")
    if not os.path.exists(fa):
        big_genome = _genome(np.random.default_rng(11), SIDE_MB << 20)
        gen_fasta(fa, rng, big_genome)
    ref = os.path.join(BDIR, "bench.ref.gxz")
    if not os.path.exists(ref):
        from genozip_tpu.ref.refstore import make_reference
        make_reference(fa, ref)
    r1 = os.path.join(BDIR, "bench_R1.fastq")
    r2 = os.path.join(BDIR, "bench_R2.fastq")
    if not os.path.exists(r1):
        if big_genome is None:
            big_genome = _genome(np.random.default_rng(11), SIDE_MB << 20)
        gen_paired_fastq(r1, r2, SIDE_MB // 2,
                         np.random.default_rng(12), big_genome)
    bam = os.path.join(BDIR, "bench.bam")
    if not os.path.exists(bam):
        rng7 = np.random.default_rng(7)
        gen_bam(bam, SIDE_MB, rng7, _genome(rng7, 32 << 20))
    vcf = os.path.join(BDIR, "bench.vcf")
    if not os.path.exists(vcf):
        gen_vcf(vcf, SIDE_MB, np.random.default_rng(9))
    lr = os.path.join(BDIR, "bench_longread.sam")
    if not os.path.exists(lr):
        if big_genome is None:
            big_genome = _genome(np.random.default_rng(11), SIDE_MB << 20)
        gen_longread_sam(lr, SIDE_MB // 2, np.random.default_rng(13),
                         big_genome)

    # warmup (compile/alloc caches) on a slice
    from genozip_tpu.zip_pipeline import zip_file, zip_pair
    warm = os.path.join(BDIR, "warm.fastq")
    if not os.path.exists(warm):
        with open(fq, "rb") as f:
            head = f.read(8 << 20)
        cut = head.rfind(b"\n@")
        open(warm, "wb").write(head[:cut + 1])
    zip_file(warm, warm + ".gxz", vb_size=16 << 20)

    cfg = {}
    # cfg3: the headline metric
    fq_mbps, fq_ratio, _ = bench_zip(fq, runs=3)
    cfg["fastq"] = (fq_mbps, fq_ratio, None, proxy_ratios(fq))
    cfg["vcf"] = (*bench_zip(vcf, runs=2),
                  proxy_ratios(vcf))
    cfg["fasta"] = (*bench_zip(fa, runs=2),
                    proxy_ratios(fa))
    cfg["bam"] = (*bench_zip(bam, runs=2),
                  proxy_ratios(bam))
    cfg["longread_sam"] = (*bench_zip(lr, runs=2,
                                      reference=ref), proxy_ratios(lr))
    # PIZ (decompression) throughput on the just-written archives
    piz = {"fastq": bench_piz(fq), "vcf": bench_piz(vcf),
           "bam": bench_piz(bam),
           "longread_sam": bench_piz(lr, reference=ref)}
    # cfg4: paired FASTQ via the aligner (one two-component archive);
    # best-of-3 — the bench host carries ~1 core of external load
    pt = None
    for _ in range(3):
        t0 = time.time()
        zip_pair(r1, r2, os.path.join(BDIR, "pair.gxz"),
                 reference=ref)
        dt = time.time() - t0
        pt = dt if pt is None else min(pt, dt)
    psz = os.path.getsize(r1) + os.path.getsize(r2)
    cfg["pair_fastq_ref"] = (psz / 1e6 / pt,
                             psz / os.path.getsize(
                                 os.path.join(BDIR, "pair.gxz")),
                             None, proxy_ratios(r1))

    baseline_mbps = None
    source = None
    if os.path.exists(BASELINE_FILE):
        try:
            b = json.load(open(BASELINE_FILE))
            baseline_mbps = b.get("fastq_zip_MBps")
            source = b.get("source")
        except Exception:
            pass
    if not baseline_mbps:
        import zlib as _z
        data = open(fq, "rb").read(16 << 20)
        t0 = time.time()
        _z.compress(data, 6)
        baseline_mbps = len(data) / 1e6 / (time.time() - t0)
        source = "gzip6-proxy"

    out = {
        "metric": "fastq_zip_MBps",
        "value": round(fq_mbps, 2),
        "unit": "MB/s",
        "vs_baseline": round(fq_mbps / baseline_mbps, 3),
        "baseline_source": source,
    }
    for nm, (mbps, ratio, txt_mbps, (gz_r, xz_r, bz_r)) in cfg.items():
        out[f"{nm}_MBps"] = round(mbps, 2)
        out[f"{nm}_ratio"] = round(ratio, 2)
        out[f"{nm}_vs_xz6"] = round(ratio / xz_r, 2)
        out[f"{nm}_vs_bz2"] = round(ratio / bz_r, 2)
        if txt_mbps:
            # compressed input (BGZF BAM): uncompressed-text basis too,
            # which is what the reference's progress meter counts
            out[f"{nm}_txt_MBps"] = round(txt_mbps, 2)
    for nm, mbps in piz.items():
        out[f"{nm}_unzip_MBps"] = round(mbps, 2)
    out["corpus"] = "v2"
    print(json.dumps(out))


if __name__ == "__main__":
    main()
