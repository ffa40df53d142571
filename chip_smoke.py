#!/usr/bin/env python
"""Smoke test of ZIP/PIZ on an NVIDIA GPU with the device rANS coder engaged.

    python chip_smoke.py          # one card: phases 0-4 below
    python chip_smoke.py --four   # four cards: the dp/mesh paths against
                                  # their one-card counterparts, nothing else

One process owns the card(s); `nvidia-smi` runs as a child that stays off
JAX. Phases (one card):

  0  the card: name and power limit, JAX version and devices; fails unless
     JAX's platform is `gpu`.
  1  the native runtime, built for this host (GXZ_REQUIRE_NATIVE=1).
  2  the device coder against the numpy spec, bit-exact: orders 0 and 1,
     encode and decode, 1024..8192 lanes, 256 KiB..8 MiB, a QUAL-like and
     a full-byte alphabet; then the `gpu`-marked tests.
  3  the CLI's `zip`/`unzip` on a >=256 MB FASTQ and a >=64 MB BGZF BAM
     (bench.py's generators, fixed seeds): output == input, the archive ==
     the archive written with the device coder off, and device-coded
     section counts > 0 in ZIP and in PIZ.
  4  timings (a finding, not a benchmark): kernel, XLA twin and native
     coder MB/s on the phase-3 payloads; ZIP/PIZ wall MB/s on the first run
     (compiles included), again, and with the device coder off.

The last line of stdout is one JSON object: {"ok": true, "device": {...}}.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

import bench
from genozip_tpu import codecs, setup_compile_cache
from genozip_tpu.cli import main as cli

WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_smoke")
FASTQ_MB, BAM_MB = 256, 64
CARD = ""


def say(*a):
    print(*a, flush=True)


def timing(what, nbytes, seconds):
    say(f"[{CARD}] {what}: {nbytes / 1e6 / seconds:.1f} MB/s "
        f"({nbytes / 1e6:.1f} MB in {seconds:.3f} s)")


def phase0():
    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(CARD)
    import jax
    dev = jax.devices()
    say(f"jax {jax.__version__}: {dev}")
    if dev[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX platform is {dev[0].platform}")
    os.environ["JAX_PLATFORMS"] = "cuda"   # keeps tests/conftest.py off CPU
    setup_compile_cache()
    return dev


def phase1():
    os.environ["GXZ_REQUIRE_NATIVE"] = "1"
    from genozip_tpu import native
    t = time.perf_counter()
    native.get()
    say(f"native runtime for this host in {time.perf_counter() - t:.1f} s: "
        f"AVX-512 {'on' if native.simd_bits() == 512 else 'OFF'}; "
        + ("libdeflate" if native.has_libdeflate() else
           "libdeflate.h MISSING on this host: zlib stand-ins in its place"))


def _payload(rng, n, alphabet):
    if alphabet == "qual":
        q = np.frombuffer(b"#,:F", np.uint8)
        return q[np.minimum(rng.geometric(0.5, n) - 1, 3)].tobytes()
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def phase2():
    import pytest
    from genozip_tpu.ops import rans_gpu, rans_np
    rng = np.random.default_rng(2)
    # choose_num_lanes: 256 KiB -> 1024, 300 KiB -> 2048, 700 KiB -> 4096,
    # >= 1 MiB -> 8192 lanes
    items = [(_payload(rng, n, a), o)
             for n in (256 << 10, 300 << 10, 700 << 10, 1 << 20, 8 << 20)
             for a in ("qual", "all") for o in (0, 1)]
    t = time.perf_counter()
    blobs = rans_gpu.encode_many(items)
    say(f"setup: encode kernels compile + first run "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    outs = rans_gpu.decode_many(blobs)
    say(f"setup: decode kernels compile + first run "
        f"{time.perf_counter() - t:.1f} s")
    bad = 0
    for (d, o), blob, out in zip(items, blobs, outs):
        ok = blob == rans_np.encode(d, order=o) and out == d
        bad += not ok
        say(f"coder vs spec: n={len(d)} order={o} lanes={1 << blob[0]} "
            f"{'exact' if ok else 'MISMATCH'}")
    assert not bad, f"{bad} device-coder results differ from the spec"
    for name, plan in (("encode", rans_gpu.encode_launches),
                       ("decode", rans_gpu.decode_launches)):
        for o in (0, 1):
            src = [it for it in items if it[1] == o][-1:] if name == "encode" \
                else [b for b, it in zip(blobs, items) if it[1] == o][-1:]
            kernel, args, _ = next(plan(src))
            mem = kernel.lower(*args).compile().memory_analysis()
            say(f"memory_analysis {name} o{o}: {mem}")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(os.path.dirname(__file__), "tests")])
    assert rc == 0, f"gpu-marked tests failed (pytest rc {rc})"


def make_inputs():
    os.makedirs(WORK, exist_ok=True)
    fq = os.path.join(WORK, "smoke.fastq")
    bam = os.path.join(WORK, "smoke.bam")
    t = time.perf_counter()
    bench.gen_fastq(fq, FASTQ_MB, np.random.default_rng(2024),
                    bench._genome(np.random.default_rng(2024)))
    rng7 = np.random.default_rng(7)
    bench.gen_bam(bam, BAM_MB, rng7, bench._genome(rng7, 32 << 20))
    say(f"setup: inputs generated in {time.perf_counter() - t:.1f} s "
        f"(FASTQ {os.path.getsize(fq):,} B, BAM {os.path.getsize(bam):,} B)")
    return fq, bam


def _wall(args):
    t = time.perf_counter()
    cli(args)
    return time.perf_counter() - t


def phase3(captured):
    from genozip_tpu.ops import rans_gpu
    fq, bam = make_inputs()
    encode_many = rans_gpu.encode_many

    def capture(items, **kw):
        blobs = encode_many(items, **kw)
        captured.extend(zip(items, blobs))
        return blobs

    walls = {}
    for path in (fq, bam):
        base, ext = os.path.splitext(path)
        z, out, zh = path + ".gxz", base + ".out" + ext, path + ".h.gxz"
        name = os.path.basename(path)
        size = os.path.getsize(path)
        shapes = (rans_gpu._encoder.cache_info().misses,
                  rans_gpu._decoder.cache_info().misses)
        rans_gpu.counts.clear()
        rans_gpu.encode_many = capture
        cold_zip = _wall(["zip", path, "-o", z, "-q"])
        rans_gpu.encode_many = encode_many
        enc = dict(rans_gpu.counts)
        rans_gpu.counts.clear()
        cold_unzip = _wall(["unzip", z, "-o", out])
        dec = dict(rans_gpu.counts)
        same_out = filecmp.cmp(path, out, shallow=False)
        say(f"{name}: new kernel shapes compiled: "
            f"{rans_gpu._encoder.cache_info().misses - shapes[0]} encode, "
            f"{rans_gpu._decoder.cache_info().misses - shapes[1]} decode")
        # steady state: the same runs again, then with the device coder off
        w = {"zip, first run": cold_zip, "unzip, first run": cold_unzip,
             "zip": _wall(["zip", path, "-o", z, "-q"]),
             "unzip": _wall(["unzip", z, "-o", out])}
        real = codecs.device_coder
        codecs.device_coder = lambda: None
        try:
            w["zip, device coder off"] = _wall(["zip", path, "-o", zh, "-q"])
            w["unzip, device coder off"] = _wall(["unzip", zh, "-o", out])
        finally:
            codecs.device_coder = real
        same_z = filecmp.cmp(z, zh, shallow=False)
        same_out &= filecmp.cmp(path, out, shallow=False)
        say(f"{name}: zip device-coded {enc.get('encode_sections', 0)} "
            f"sections / {enc.get('encode_bytes', 0):,} B in "
            f"{enc.get('encode_launches', 0)} launches; unzip "
            f"{dec.get('decode_sections', 0)} sections / "
            f"{dec.get('decode_bytes', 0):,} B in "
            f"{dec.get('decode_launches', 0)} launches; output == input "
            f"{same_out}; archive == host-coded archive {same_z}; "
            f"ratio {size / os.path.getsize(z):.2f}")
        assert same_out and same_z, name
        assert enc.get("encode_sections") and dec.get("decode_sections"), name
        for k, v in (("encode", enc), ("decode", dec)):
            say(f"occupancy {name} {k}: "
                f"{v[k + '_sections'] / v[k + '_launches']:.1f} programs "
                f"(one stream each) per launch on 132 SMs")
        walls[name] = (size, w)
        for f in (out, zh):
            os.remove(f)
    return walls


def _timed(fn, reps=3):
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps


def phase4(captured, walls):
    import jax
    from genozip_tpu import native
    from genozip_tpu.ops import rans_gpu, rans_jax, rans_np
    # up to 16 streams of each input: the widths and sizes ZIP produced
    sample = captured[:16] + captured[-16:]
    items = [it for it, _ in sample]
    blobs = [b for _, b in sample]
    total = sum(len(d) for d, _ in items)
    say(f"phase 4 sample: {len(items)} streams, lanes "
        f"{sorted({1 << b[0] for b in blobs})}, orders "
        f"{sorted({o for _, o in items})}, {total:,} B")

    def kernel_only(launches):
        staged = [(k, [jax.device_put(a) for a in args])
                  for k, args, _ in launches]
        return lambda: jax.block_until_ready(
            [k(*args) for k, args in staged])

    def xla_encode_only():
        staged = []
        for d, o in items:
            a = np.frombuffer(d, np.uint8)
            N = rans_np.choose_num_lanes(a.shape[0])
            etab, _ = rans_jax.encode_tables(a, N, o)
            staged.append((jax.device_put(a), a.shape[0],
                           jax.device_put(etab), rans_np.lane_layout(
                               a.shape[0], N)[0], N, o))
        return lambda: jax.block_until_ready(
            [rans_jax._encode_device(d, n, t, Kmax=K, N=N, order=o)
             for d, n, t, K, N, o in staged])

    def xla_decode_only():
        staged = []
        for b in blobs:
            N, o, n, etab, s2s, words = rans_jax.decode_tables(b)
            staged.append((jax.device_put(words), n, jax.device_put(etab),
                           jax.device_put(s2s),
                           rans_np.lane_layout(n, N)[0], N, o))
        return lambda: jax.block_until_ready(
            [rans_jax._decode_device(w, n, t, q, K=K, N=N, order=o)
             for w, n, t, q, K, N, o in staged])

    rows = [
        ("encode kernel only", kernel_only(rans_gpu.encode_launches(items))),
        ("encode kernel end to end", lambda: rans_gpu.encode_many(items)),
        ("encode XLA twin only", xla_encode_only()),
        ("encode XLA twin end to end",
         lambda: [rans_jax.encode(d, o) for d, o in items]),
        ("encode native", lambda: [native.rans_encode(d, o)
                                   for d, o in items]),
        ("decode kernel only", kernel_only(rans_gpu.decode_launches(blobs))),
        ("decode kernel end to end", lambda: rans_gpu.decode_many(blobs)),
        ("decode XLA twin only", xla_decode_only()),
        ("decode XLA twin end to end",
         lambda: [rans_jax.decode(b) for b in blobs]),
        ("decode native", lambda: [native.rans_decode(b) for b in blobs]),
    ]
    for what, fn in rows:
        timing(what, total, _timed(fn))
    for name, (size, w) in walls.items():
        for what, seconds in w.items():
            timing(f"{name} {what} wall", size, seconds)


def four():
    """dp and mesh on four cards against their one-card counterparts."""
    import jax
    from genozip_tpu.parallel.piz_sharded import piz_file_dp
    from genozip_tpu.ref.refstore import make_reference
    assert len(jax.devices()) >= 4, f"--four needs 4 cards: {jax.devices()}"
    fq, bam = make_inputs()

    def same(a, b, what):
        ok = filecmp.cmp(a, b, shallow=False)
        say(f"{what}: {'identical' if ok else 'DIFFERENT'}")
        assert ok, what

    for path in (fq, bam):
        name = os.path.basename(path)
        one, dp = path + ".1.gxz", path + ".dp.gxz"
        t = time.perf_counter()
        cli(["zip", path, "-o", one, "-q"])
        t1 = time.perf_counter() - t
        t = time.perf_counter()
        cli(["zip", path, "-o", dp, "-q", "--dp", "4"])
        t4 = time.perf_counter() - t
        timing(f"{name} zip one card", os.path.getsize(path), t1)
        timing(f"{name} zip --dp 4", os.path.getsize(path), t4)
        same(one, dp, f"{name}: zip --dp 4 archive vs one card")
        # plain (not BGZF) outputs on both sides: piz_file_dp writes text
        o1, o4 = path + ".o1", path + ".o4"
        cli(["unzip", one, "-o", o1])
        t = time.perf_counter()
        piz_file_dp(one, o4, dp=4)
        timing(f"{name} piz_file_dp(dp=4)", os.path.getsize(path),
               time.perf_counter() - t)
        same(o1, o4, f"{name}: piz_file_dp(dp=4) output vs one card")

    # aligner mesh: R1 of a paired FASTQ against the 24 Mbp bench genome
    g = bench._genome(np.random.default_rng(11), bench.SIDE_MB << 20)
    fa, ref = os.path.join(WORK, "g.fa"), os.path.join(WORK, "g.ref.gxz")
    r1, r2 = os.path.join(WORK, "r1.fastq"), os.path.join(WORK, "r2.fastq")
    bench.gen_fasta(fa, np.random.default_rng(2024), g)
    make_reference(fa, ref)
    bench.gen_paired_fastq(r1, r2, bench.SIDE_MB // 2,
                           np.random.default_rng(12), g)
    # the sharded aligner is its own algorithm (its archives differ from
    # the host aligner's), so its one-card counterpart is --mesh 1
    one, mesh = r1 + ".1.gxz", r1 + ".mesh.gxz"
    cli(["zip", r1, "-o", one, "-q", "--reference", ref, "--mesh", "1"])
    t = time.perf_counter()
    cli(["zip", r1, "-o", mesh, "-q", "--reference", ref, "--mesh", "4"])
    timing("R1 zip --mesh 4 --reference", os.path.getsize(r1),
           time.perf_counter() - t)
    same(one, mesh, "R1: zip --mesh 4 archive vs --mesh 1")
    cli(["unzip", mesh, "-o", r1 + ".out", "--reference", ref])
    same(r1, r1 + ".out", "R1: unzip of the --mesh 4 archive vs input")


def run():
    devs = phase0()
    if "--four" in sys.argv:
        phase1()
        four()
        return devs
    phase1()
    phase2()
    captured = []
    walls = phase3(captured)
    phase4(captured, walls)
    return devs


if __name__ == "__main__":
    try:
        devs = run()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    say(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
