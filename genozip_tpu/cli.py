"""CLI: four personalities from one entrypoint, like the reference binary
(reference src/genozip.c:723-745 ExeType): gxzip (compress), gxunzip
(decompress), gxcat (decompress to stdout with filters), gxls (list archive
metadata).
"""

import argparse
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="gxzip",
                                description="genomic compressor")
    sub = p.add_subparsers(dest="cmd", required=True)

    z = sub.add_parser("zip", help="compress")
    z.add_argument("input")
    z.add_argument("input2", nargs="*", default=[],
                   help="more inputs (R2 for --pair; multiple files with --tar)")
    z.add_argument("--pair", action="store_true",
                   help="co-compress paired R1/R2 FASTQ files")
    z.add_argument("--bamass", default=None,
                   help="use an existing BAM's alignments for FASTQ SEQ "
                        "without storing the BAM (reference --bamass)")
    z.add_argument("--deep", action="store_true",
                   help="co-compress a BAM with its FASTQ(s) (reference --deep)")
    z.add_argument("-o", "--output")
    z.add_argument("--input-type", dest="dt", default=None)
    z.add_argument("--vblock", type=int, default=None, help="VB size in MB")
    z.add_argument("--stats", action="store_true")
    z.add_argument("--show-time", action="store_true",
                   help="wall-clock region profile (reference --show-time)")
    z.add_argument("--test", action="store_true",
                   help="verify by decompress+digest after compressing")
    z.add_argument("--reference", default=None)
    z.add_argument("--REFERENCE", "--store-reference", dest="store_ref",
                   action="store_true",
                   help="also embed the used reference ranges in the "
                        "archive so unzip needs no .ref file "
                        "(REF_EXT_STORE, reference flags.h:16-21)")
    z.add_argument("--password", default=None,
                   help="encrypt with AES-256 (reference --password)")
    z.add_argument("--mesh", type=int, default=None,
                   help="shard the aligner (genome+refhash over 'mp', reads "
                        "over 'dp') across N devices")
    z.add_argument("--dp", type=int, default=None,
                   help="VBs data-parallel over N devices: section payloads "
                        "encoded by one dp-sharded kernel; archive bytes "
                        "identical to the single-host path")
    z.add_argument("--hosts", type=int, default=None,
                   help="multi-host ZIP: N jax.distributed processes seg "
                        "VB stripes in parallel (dict-merge collective over "
                        "DCN); archive bytes identical to single-process")

    z.add_argument("--make-reference", action="store_true",
                   help="compress a FASTA into a .ref.gxz reference")
    z.add_argument("--fast", action="store_true",
                   help="favor speed: fewer codec trials, 2-seed aligner")
    z.add_argument("--replace", action="store_true",
                   help="remove the input file after a successful zip "
                        "(implies --test; genozip --replace analog)")
    z.add_argument("-q", "--quiet", action="store_true",
                   help="suppress progress output")
    z.add_argument("--optimize", action="store_true",
                   help="LOSSY: bin QUAL to the Illumina 8-level scheme "
                        "(genozip --optimize analog; the archive digest "
                        "covers the modified data)")
    z.add_argument("--best", action="store_true",
                   help="favor ratio: wider codec trials, larger samples")
    z.add_argument("-@", "--threads", type=int, default=None,
                   help="seg worker threads (default: all cores; "
                        "genozip --threads analog)")
    z.add_argument("--truncate", action="store_true",
                   help="accept inputs cut mid-record (reference --truncate)")
    z.add_argument("--md5", action="store_true",
                   help="use MD5 for the whole-file digest (reference --md5)")
    z.add_argument("--tar", default=None,
                   help="write archives into a tar file (reference --tar)")
    z.add_argument("--biopsy", type=int, default=None,
                   help="extract VB N's raw text for debugging (reference --biopsy)")

    u = sub.add_parser("unzip", help="decompress")
    u.add_argument("input")
    u.add_argument("-o", "--output")
    u.add_argument("--test", action="store_true", help="verify only")
    u.add_argument("--reference", default=None)
    u.add_argument("--password", default=None)
    u.add_argument("--show-time", action="store_true")

    c = sub.add_parser("cat", help="decompress to stdout")
    c.add_argument("input")
    c.add_argument("--head", type=int, default=None)
    c.add_argument("--tail", type=int, default=None)
    c.add_argument("--grep", default=None)
    c.add_argument("--downsample", type=int, default=None)
    c.add_argument("-r", "--regions", default=None,
                   help="chr[:start-end][,...] region filter")
    c.add_argument("--no-header", action="store_true")
    c.add_argument("--header-only", action="store_true",
                   help="emit only the txt header (genocat --header-only)")
    c.add_argument("--seq-only", action="store_true",
                   help="one SEQ line per record (genocat --seq-only)")
    c.add_argument("--qual-only", action="store_true",
                   help="one QUAL line per record (genocat --qual-only)")
    c.add_argument("--one-vb", type=int, default=None,
                   help="reconstruct a single VB (genocat --one-vb)")
    c.add_argument("--r1", action="store_true",
                   help="emit only R1 of a paired archive (genocat --R1)")
    c.add_argument("--r2", action="store_true",
                   help="emit only R2 of a paired archive (genocat --R2)")
    c.add_argument("--bases", default=None,
                   help="keep reads whose SEQ uses only these IUPAC chars "
                        "(^ prefix negates; reference --bases)")
    c.add_argument("--count", action="store_true",
                   help="print the number of records that pass the filters")
    c.add_argument("--lines", default=None,
                   help="record range first-last, 1-based inclusive "
                        "(reference --lines)")
    c.add_argument("--qnames", default=None,
                   help="comma-separated QNAMEs, or @FILE with one per line "
                        "(reference --qnames / qname_filter.c)")
    c.add_argument("--reference", default=None)
    c.add_argument("--password", default=None)
    c.add_argument("--sam", action="store_true",
                   help="translate a BAM archive to SAM text (reference: genocat --sam)")
    c.add_argument("--bam", action="store_true",
                   help="translate a SAM archive to BAM (reference: genocat "
                        "--bam; data_types.h:253-259 SAM2BAM translators)")
    c.add_argument("-o", "--output", default=None,
                   help="write translated output to FILE instead of stdout")
    c.add_argument("--index", action="store_true",
                   help="with --bam -o FILE: also write FILE.bai "
                        "(reference src/bai.c)")
    c.add_argument("--cram", action="store_true",
                   help="translate a SAM/BAM archive to CRAM via samtools "
                        "(reference: genocat --cram, src/cram.c bridge)")
    c.add_argument("--cram-ref", default=None,
                   help="FASTA passed to samtools -T for CRAM encoding")
    c.add_argument("--vcf", action="store_true",
                   help="translate a 23andMe archive to VCF (needs --reference)")
    c.add_argument("--interleave", action="store_true",
                   help="interleave R1/R2 records of a paired archive")
    c.add_argument("--coverage", action="store_true",
                   help="per-contig read/base counts (reference --coverage)")
    c.add_argument("--idxstats", action="store_true",
                   help="samtools-idxstats-style output (reference --idxstats)")

    l = sub.add_parser("ls", help="list archive metadata")
    l.add_argument("inputs", nargs="+")
    l.add_argument("--stats", action="store_true",
                   help="per-context compressed-size table (SEC_STATS)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from . import setup_compile_cache
    setup_compile_cache()
    # env fallback (reference parity: GENOZIP_REFERENCE, genozip.h:85)
    if getattr(args, "reference", None) is None and os.environ.get("GXZ_REFERENCE"):
        args.reference = os.environ["GXZ_REFERENCE"]
    if getattr(args, "quiet", False):
        from .utils import progress as _prog
        _prog.set_quiet(True)
    if args.cmd == "zip":
        if args.make_reference:
            from .ref.refstore import make_reference
            out = args.output or args.input + ".ref.gxz"
            ref = make_reference(args.input, out)
            print(f"reference: {ref.length:,} bases, "
                  f"{len(ref.contigs)} contigs -> {out}")
            return 0
        from .zip_pipeline import zip_file, zip_pair
        from .codecs import assign as _assign
        if args.fast:
            _assign.set_mode("fast")
            from .ref import aligner as _al
            _al.NUM_SEEDS = 2
        elif args.best:
            _assign.set_mode("best")
        from .txtfile import DEFAULT_VB_SIZE
        out = args.output or args.input + ".gxz"
        vb = (args.vblock * (1 << 20)) if args.vblock else None
        if args.biopsy is not None:
            from .biopsy import biopsy_take
            path = biopsy_take(args.input, args.biopsy, dt_name=args.dt,
                               vb_size=vb)
            print(f"biopsy: VB {args.biopsy} -> {path}")
            return 0
        if args.tar:
            import tarfile, tempfile
            inputs = [args.input] + list(args.input2)
            with tarfile.open(args.tar, "w") as tf:
                for inp in inputs:
                    tmp = tempfile.NamedTemporaryFile(delete=False, suffix=".gxz")
                    tmp.close()
                    zip_file(inp, tmp.name, dt_name=args.dt, vb_size=vb,
                             reference=args.reference, password=args.password,
                             use_md5=args.md5)
                    tf.add(tmp.name, arcname=inp.rsplit("/", 1)[-1] + ".gxz")
                    os.unlink(tmp.name)
            print(f"tar: {len(inputs)} archive(s) -> {args.tar}")
            return 0
        if args.deep:
            from .zip_pipeline import zip_deep
            assert args.input2, "--deep needs a BAM plus FASTQ input(s)"
            stats = zip_deep(args.input, list(args.input2), out, vb_size=vb,
                             show_stats=args.stats, reference=args.reference)
            if args.test:
                from .piz_pipeline import piz_file
                piz_file(out, None, reference=args.reference)
                print("verified: round-trip digest OK")
            return 0
        if args.pair:
            assert args.input2, "--pair needs two FASTQ inputs"
            stats = zip_pair(args.input, args.input2[0], out, vb_size=vb,
                             show_stats=args.stats, reference=args.reference,
                             optimize=args.optimize)
        elif args.hosts and args.hosts > 1:
            from .parallel.multihost import zip_file_multihost
            zip_file_multihost(args.input, out, n_procs=args.hosts,
                               vb_size=vb)
            stats = None
        else:
            stats = zip_file(args.input, out, dt_name=args.dt, vb_size=vb,
                             show_stats=args.stats, reference=args.reference,
                             password=args.password, use_md5=args.md5,
                             bamass=args.bamass, truncate=args.truncate,
                             mesh=args.mesh, dp=args.dp,
                             store_ref=args.store_ref,
                             threads=args.threads, optimize=args.optimize)
        if args.test or args.replace:
            from .piz_pipeline import piz_file
            piz_file(out, None, reference=args.reference,
                     password=args.password)
            print("verified: round-trip digest OK")
        if args.replace:
            # reference --replace: remove the input only after the archive's
            # digest verified above
            os.unlink(args.input)
            for extra in args.input2:
                os.unlink(extra)
        if args.show_time:
            from .utils import profiler
            print(profiler.report())
        return 0
    if args.cmd == "unzip":
        from .piz_pipeline import piz_file
        if args.test:
            piz_file(args.input, None, reference=args.reference,
                     password=args.password)
            print("verified: round-trip digest OK")
            return 0
        out = args.output or args.input.removesuffix(".gxz")
        if out == args.input:
            out = args.input + ".out"
        piz_file(args.input, out, reference=args.reference,
                 password=args.password)
        if args.show_time:
            from .utils import profiler
            print(profiler.report())
        return 0
    if args.cmd == "cat":
        from .piz_pipeline import PizReader
        from .filters import cat_filtered, cat_translated_sam, cat_interleaved
        if args.coverage or args.idxstats:
            from .coverage import show_coverage
            show_coverage(args, sys.stdout)
        elif args.sam:
            cat_translated_sam(args, sys.stdout.buffer)
        elif args.bam:
            from .filters import cat_translated_bam
            cat_translated_bam(args, args.output)
        elif args.cram:
            from .filters import cat_translated_cram
            cat_translated_cram(args, args.output)
        elif args.vcf:
            from .filters import cat_translated_vcf
            cat_translated_vcf(args, sys.stdout.buffer)
        elif args.interleave:
            cat_interleaved(args, sys.stdout.buffer)
        else:
            cat_filtered(args, sys.stdout.buffer)
        return 0
    if args.cmd == "ls":
        from .format import sections as fmt
        from .piz_pipeline import PizReader
        print(f"{'name':30s} {'type':8s} {'txt_len':>14s} {'z_len':>14s} "
              f"{'ratio':>7s} {'lines':>12s}")
        for path in args.inputs:
            pr = PizReader(path)
            h = pr.file_hdr
            zlen = os.path.getsize(path)
            print(f"{h.get('txt_name', path):30s} {h['dt']:8s} "
                  f"{h['txt_len']:>14,} {zlen:>14,} "
                  f"{h['txt_len'] / max(zlen, 1):>6.1f}x {h['num_lines']:>12,}")
            if args.stats:
                payload, _ = pr.zr.read_one(fmt.SEC_STATS)
                if payload is not None:
                    per_ctx = fmt.json_parse(payload)
                    for name, (u_, z_) in sorted(per_ctx.items(),
                                                 key=lambda kv: -kv[1][1]):
                        print(f"    {name:14s} z {z_:>12,} "
                              f"({100.0 * z_ / max(zlen, 1):5.1f}%)")
            pr.close()
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
