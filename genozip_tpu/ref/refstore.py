"""Reference genome store: --make-reference (FASTA -> .ref.gxz), load, and
in-memory genome representation.

Reference parity: src/ref_make.c (FASTA -> 2-bit genome), src/reference.c
(genome store), src/refhash_make.c (kmer->GPOS seed table), src/ref_contigs.c
(contig catalog), src/ref_iupacs.c (non-ACGT exceptions). Vectorized redesign:
the genome is a flat code array (2-bit packed on disk, bytes in RAM, u32-packed
on device); the refhash is a single power-of-two open-addressed table built
with one vectorized first-wins scatter (the reference's multi-layer
occupancy dispatchers collapse into numpy/jnp ops); seeds are direct k-mers
at every position (no 'G'-hook scan — batched gathers don't need the
density trick).
"""

import json

import numpy as np

from ..format import sections as fmt
from ..ops import pack as packops
from .. import codecs
from ..codecs import assign as codec_assign

KMER = 16               # seed length (u32-packable)
HASH_BITS_DEFAULT = 24  # refhash slots = 2^bits
FIB32 = np.uint32(2654435761)  # 2^32 / phi (u32 math: device-safe without x64)
NO_GPOS = np.uint32(0xFFFFFFFF)


def chrom_canonical(name: str) -> str:
    """Canonical chrom key for alt-name matching (reference src/chrom.c:330):
    drop a "chr" prefix and fold mitochondrial spellings M/chrM/MT to "MT"."""
    if name.startswith("chr") or name.startswith("Chr"):
        name = name[3:]
    if name in ("M", "m", "mt"):
        name = "MT"
    return name


class RefGenome:
    def __init__(self, codes: np.ndarray, contigs, refhash=None,
                 hash_bits=HASH_BITS_DEFAULT, iupac_pos=None, iupac_chars=None):
        self.codes = codes          # (G,) uint8 in 0..3
        self.contigs = contigs      # list of {name, gpos, length}
        self.refhash = refhash      # (2^bits,) uint32 GPOS or NO_GPOS
        self.hash_bits = hash_bits
        self.iupac_pos = iupac_pos if iupac_pos is not None else np.zeros(0, np.int64)
        self.iupac_chars = iupac_chars if iupac_chars is not None else np.zeros(0, np.uint8)

    @property
    def length(self):
        return self.codes.shape[0]

    def contig_of(self, name: str):
        """Contig lookup with alt-name matching (reference src/chrom.c:330
        chrom_2ref_seg: "chr22"<->"22", "chrM"<->"MT"<->"M") so a file whose
        naming style differs from the reference FASTA still aligns."""
        for c in self.contigs:
            if c["name"] == name:
                return c
        want = chrom_canonical(name)
        for c in self.contigs:
            if chrom_canonical(c["name"]) == want:
                return c
        return None

    BLOCK = 4096  # usage-tracking granularity (REF_EXT_STORE)

    def mark_used(self, starts: np.ndarray, lens: np.ndarray):
        """Record genome ranges touched by seg (REF_EXT_STORE usage
        tracking, reference src/reference.c is_set bitmaps). Block-level:
        a bool per 4KB block."""
        if not getattr(self, "track_used", False) or starts.shape[0] == 0:
            return
        if getattr(self, "used_blocks", None) is None:
            self.used_blocks = np.zeros(
                (self.length + self.BLOCK - 1) // self.BLOCK + 1, bool)
        s = np.clip(starts.astype(np.int64), 0, self.length - 1)
        e = np.clip(starts.astype(np.int64) + np.maximum(lens, 1),
                    1, self.length)
        b0 = s // self.BLOCK
        b1 = (e - 1) // self.BLOCK
        span = int((b1 - b0).max()) if b0.shape[0] else 0
        for k in range(span + 1):
            self.used_blocks[np.minimum(b0 + k, b1)] = True

    def used_ranges(self):
        """(start, len) base ranges from the block bitmap, merged."""
        ub = getattr(self, "used_blocks", None)
        if ub is None or not ub.any():
            return []
        blocks = np.nonzero(ub)[0]
        brk = np.nonzero(np.diff(blocks) > 1)[0]
        starts_b = np.concatenate([[blocks[0]], blocks[brk + 1]])
        ends_b = np.concatenate([blocks[brk], [blocks[-1]]])
        out = []
        for sb, eb in zip(starts_b, ends_b):
            s = int(sb) * self.BLOCK
            e = min((int(eb) + 1) * self.BLOCK, self.length)
            if e > s:
                out.append((s, e - s))
        return out


def kmers_at(codes: np.ndarray, positions: np.ndarray, k: int = KMER):
    """Pack k consecutive 2-bit codes starting at each position into u32
    (k == 16 fills exactly 32 bits; vectorized; caller guarantees
    positions + k <= len)."""
    out = np.zeros(positions.shape[0], dtype=np.uint32)
    for j in range(k):
        out = (out << np.uint32(2)) | codes[positions + j].astype(np.uint32)
    return out


def hash_kmer(kmer: np.ndarray, bits: int):
    """32-bit Fibonacci hash — identical results in numpy and on-device
    uint32 (wrapping) arithmetic."""
    return ((kmer.astype(np.uint32) * FIB32) >> np.uint32(32 - bits)).astype(np.int64)


def build_refhash(codes: np.ndarray, bits: int = HASH_BITS_DEFAULT,
                  stride: int = 1, layers: int = 2):
    """kmer->GPOS table, LAYERED (reference src/refhash_make.c occupancy
    layers): layer 0 holds the smallest GPOS per slot, layer 1 the second
    smallest — repetitive kmers get two candidate loci instead of one
    (hit-rate on repetitive genomes). Flat layout [layer0 | layer1] so the
    on-disk and mmap-cache formats are unchanged; consumers detect layer 1
    by the array length. One vectorized pass, chunked."""
    G = codes.shape[0]
    size = 1 << bits
    table = np.full(layers * size, NO_GPOS, dtype=np.uint32)
    if G < KMER:
        return table
    t0 = table[:size]
    t1 = table[size:2 * size] if layers > 1 else None
    chunk = 1 << 22
    for start in range(0, G - KMER + 1, chunk):
        end = min(start + chunk, G - KMER + 1)
        pos = np.arange(start, end, stride, dtype=np.int64)
        km = kmers_at(codes, pos)
        h = hash_kmer(km, bits)
        if t1 is None:
            np.minimum.at(t0, h, pos.astype(np.uint32))
            continue
        # per-slot two smallest GPOSes this chunk, merged with the tables
        order = np.argsort(h, kind="stable")   # pos already ascending
        hs = h[order]
        ps = pos[order].astype(np.uint32)
        k = hs.shape[0]
        firstm = np.ones(k, bool)
        firstm[1:] = hs[1:] != hs[:-1]
        runidx = np.nonzero(firstm)[0]
        c0h = hs[runidx]
        c0p = ps[runidx]
        nxt = runidx + 1
        nxt = nxt[nxt < k]
        second_sel = nxt[~firstm[nxt]]
        c1p = np.full(runidx.shape[0], NO_GPOS, np.uint32)
        ri = np.searchsorted(runidx, second_sel, side="right") - 1
        c1p[ri] = ps[second_sel]
        stack = np.stack([t0[c0h], t1[c0h], c0p, c1p])
        stack.sort(axis=0)   # GPOSes are globally distinct; NO_GPOS last
        t0[c0h] = stack[0]
        t1[c0h] = stack[1]
    return table


def fasta_to_genome(fa_data: bytes, hash_bits: int = HASH_BITS_DEFAULT):
    """Parse FASTA bytes -> RefGenome (with refhash)."""
    data = np.frombuffer(fa_data, dtype=np.uint8)
    nl = np.nonzero(data == ord("\n"))[0]
    if data.shape[0] and (nl.shape[0] == 0 or nl[-1] != data.shape[0] - 1):
        nl = np.concatenate([nl, [data.shape[0]]])
    starts = np.concatenate([[0], nl[:-1] + 1])
    lens = nl - starts
    first = np.where(lens > 0, data[np.minimum(starts, data.shape[0] - 1)], 0)
    is_desc = first == ord(">")

    contigs = []
    code_parts = []
    iupac_pos_parts = []
    iupac_chr_parts = []
    gpos = 0
    cur_name = None
    cur_len = 0
    n = nl.shape[0]
    i = 0
    # contig boundaries: split on desc lines (few — python loop over contigs ok)
    desc_rows = np.nonzero(is_desc)[0]
    bounds = list(desc_rows) + [n]
    for di in range(len(desc_rows)):
        row = desc_rows[di]
        name = bytes(data[starts[row] + 1: starts[row] + lens[row]]).split()[0].decode()
        seq_rows = np.arange(bounds[di] + 1, bounds[di + 1])
        seq_rows = seq_rows[~is_desc[seq_rows]] if seq_rows.shape[0] else seq_rows
        if seq_rows.shape[0]:
            total = int(lens[seq_rows].sum())
            seq = np.empty(total, dtype=np.uint8)
            o = 0
            src = np.repeat(starts[seq_rows] - np.concatenate([[0], np.cumsum(lens[seq_rows])])[:-1], lens[seq_rows])
            src += np.arange(total, dtype=np.int64)
            seq = data[src]
        else:
            seq = np.zeros(0, np.uint8)
        # uppercase (soft-masked references are lowercase)
        seq = np.where((seq >= ord("a")) & (seq <= ord("z")), seq - 32, seq)
        codes = packops.BASE2BIT[seq]
        non_acgt = ~packops.IS_ACGT[seq]
        if non_acgt.any():
            iupac_pos_parts.append(np.nonzero(non_acgt)[0] + gpos)
            iupac_chr_parts.append(seq[non_acgt])
        code_parts.append(codes)
        contigs.append({"name": name, "gpos": gpos, "length": int(seq.shape[0])})
        gpos += int(seq.shape[0])

    codes = np.concatenate(code_parts) if code_parts else np.zeros(0, np.uint8)
    ref = RefGenome(codes, contigs, hash_bits=hash_bits,
                    iupac_pos=np.concatenate(iupac_pos_parts) if iupac_pos_parts else None,
                    iupac_chars=np.concatenate(iupac_chr_parts) if iupac_chr_parts else None)
    ref.refhash = build_refhash(codes, hash_bits)
    return ref


def write_ref_file(ref: RefGenome, out_path: str):
    """Write a .ref.gxz archive (reference parity: SEC_REFERENCE /
    SEC_REF_HASH / SEC_REF_CONTIGS / SEC_REF_IUPACS sections)."""
    with open(out_path, "wb") as f:
        zw = fmt.ZWriter(f)
        packed = packops.pack_np(ref.codes, 2)
        zw.write_section(fmt.SEC_REFERENCE, packed.tobytes(),
                         codec=codecs.RANS0, param=ref.length)
        zw.write_section(fmt.SEC_REF_CONTIGS,
                         fmt.json_payload(ref.contigs), codec=codecs.ZLIB)
        ht = ref.refhash.astype("<u4").tobytes()
        zw.write_section(fmt.SEC_REF_HASH, ht, codec=codecs.RANS0,
                         param=ref.hash_bits)
        iup = ref.iupac_pos.astype("<u8").tobytes() + ref.iupac_chars.tobytes()
        zw.write_section(fmt.SEC_REF_IUPACS, iup, codec=codecs.ZLIB,
                         param=ref.iupac_pos.shape[0])
        hdr = {"version": 1, "dt": "ref", "genome_len": ref.length,
               "hash_bits": ref.hash_bits, "kmer": KMER,
               "num_vbs": 0, "num_lines": 0, "txt_len": 0, "adler": 1}
        zw.write_section(fmt.SEC_FILE_HEADER, fmt.json_payload(hdr),
                         codec=codecs.ZLIB)
        zw.finalize()


def load_ref_file(path: str, cache: bool = True) -> RefGenome:
    """Load a .ref.gxz. With cache=True (default), the unpacked genome +
    refhash are memory-mapped from a sidecar cache file created on first
    load (reference parity: src/ref_cache.c — the shared-memory genome
    cache across processes; here an mmap'd sidecar shared by the OS page
    cache). GXZ_NO_REF_CACHE=1 disables."""
    import os
    import time as _time
    if cache and not os.environ.get("GXZ_NO_REF_CACHE"):
        cpath = path + ".cache"
        # eviction (src/ref_cache.c:30-123 auto-eviction role): sibling
        # caches idle past the TTL are reclaimed; each use refreshes the
        # cache's mtime, which doubles as the last-used stamp
        ttl_s = float(os.environ.get("GXZ_REF_CACHE_TTL_H", "168")) * 3600
        try:
            d = os.path.dirname(os.path.abspath(path)) or "."
            now = _time.time()
            for nm in os.listdir(d):
                if not nm.endswith(".cache"):
                    continue
                fp = os.path.join(d, nm)
                if fp != os.path.abspath(cpath) and \
                        now - os.path.getmtime(fp) > ttl_s:
                    os.unlink(fp)
        except OSError:
            pass
        try:
            src_m = os.path.getmtime(path)
            if os.path.exists(cpath) and os.path.getmtime(cpath) >= src_m:
                os.utime(cpath)   # last-used stamp (stays >= src mtime)
                return _load_ref_cache(path, cpath)
        except OSError:
            pass
        ref = load_ref_file(path, cache=False)
        try:
            _write_ref_cache(ref, cpath)
            return _load_ref_cache(path, cpath)
        except OSError:
            return ref
    with open(path, "rb") as f:
        zr = fmt.ZReader(f)
        hdr = fmt.json_parse(zr.read_one(fmt.SEC_FILE_HEADER)[0])
        assert hdr["dt"] == "ref", "not a reference file"
        payload, meta = zr.read_one(fmt.SEC_REFERENCE)
        codes = packops.unpack_np(np.frombuffer(payload, np.uint8), 2,
                                  meta["param"])
        contigs = fmt.json_parse(zr.read_one(fmt.SEC_REF_CONTIGS)[0])
        payload, meta = zr.read_one(fmt.SEC_REF_HASH)
        refhash = np.frombuffer(payload, "<u4").copy()
        hash_bits = meta["param"]
        payload, meta = zr.read_one(fmt.SEC_REF_IUPACS)
        ni = meta["param"]
        iupac_pos = np.frombuffer(payload[:8 * ni], "<u8").astype(np.int64)
        iupac_chars = np.frombuffer(payload[8 * ni:], np.uint8).copy()
        return RefGenome(codes, contigs, refhash, hash_bits,
                         iupac_pos, iupac_chars)


_CACHE_MAGIC = b"GXZRC1\0\0"


def _write_ref_cache(ref: RefGenome, cpath: str):
    import json
    import os
    meta = json.dumps({"hash_bits": ref.hash_bits, "glen": ref.length,
                       "nhash": int(ref.refhash.shape[0]),
                       "niupac": int(ref.iupac_pos.shape[0]
                                     if ref.iupac_pos is not None else 0),
                       "contigs": ref.contigs}).encode()
    meta += b" " * (-(len(meta)) % 8)       # 8-align sections for mmap views
    tmp = cpath + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_CACHE_MAGIC)
        f.write(len(meta).to_bytes(8, "little"))
        f.write(meta)
        f.write(ref.codes.tobytes())
        f.write(b"\0" * (-ref.length % 8))
        f.write(ref.refhash.astype("<u4").tobytes())
        if ref.iupac_pos is not None:
            f.write(ref.iupac_pos.astype("<i8").tobytes())
            f.write(ref.iupac_chars.tobytes())
    os.replace(tmp, cpath)  # atomic: concurrent loaders see old or new


def _load_ref_cache(path: str, cpath: str) -> RefGenome:
    import json
    mm = np.memmap(cpath, dtype=np.uint8, mode="r")
    assert bytes(mm[:8]) == _CACHE_MAGIC, "bad reference cache"
    mlen = int.from_bytes(bytes(mm[8:16]), "little")
    meta = json.loads(bytes(mm[16:16 + mlen]).decode())
    o = 16 + mlen
    glen, nh, ni = meta["glen"], meta["nhash"], meta["niupac"]
    # re-view as base ndarray: fancy-indexing a np.memmap subclass routes
    # every gather through memmap.__getitem__ (measurably hot in the
    # aligner); a plain ndarray view of the same mapping doesn't
    codes = mm[o:o + glen].view(np.ndarray)
    o += glen + (-glen % 8)
    refhash = mm[o:o + 4 * nh].view("<u4").view(np.ndarray)
    o += 4 * nh
    iupac_pos = iupac_chars = None
    if ni:
        iupac_pos = mm[o:o + 8 * ni].view("<i8").astype(np.int64)
        iupac_chars = np.asarray(mm[o + 8 * ni:o + 9 * ni])
    return RefGenome(codes, meta["contigs"], refhash, meta["hash_bits"],
                     iupac_pos, iupac_chars)


def make_reference(fa_path: str, out_path: str,
                   hash_bits: int = HASH_BITS_DEFAULT):
    from ..txtfile import open_input
    with open_input(fa_path) as f:
        fa = f.read()
    ref = fasta_to_genome(fa, hash_bits)
    write_ref_file(ref, out_path)
    return ref
