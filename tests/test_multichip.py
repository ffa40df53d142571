"""Multi-chip sharding tests on the virtual 8-device CPU mesh: the sharded
encode step (psum'd histogram = collective stats merge) and the 2D-sharded
aligner (mp-sharded refhash + genome slabs) must agree with the host
reference implementations."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import pytest

from genozip_tpu.parallel.flagship import make_mesh, make_sharded_step, example_batch
from genozip_tpu.parallel import aligner_sharded
from genozip_tpu.ref import refstore, aligner as host_aligner
from genozip_tpu.ops import pack as packops
from genozip_tpu.utils import ragged
from genozip_tpu.utils.ragged import Col
from tests.test_aligner import synth_genome, sample_reads


def test_sharded_encode_step():
    mesh = make_mesh(8)
    step = make_sharded_step(mesh)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    seq, qual, _, _ = example_batch(reads=64 * dp, read_len=64 * sp)
    xs = jax.device_put(jnp.asarray(seq), NamedSharding(mesh, P("dp", "sp")))
    xq = jax.device_put(jnp.asarray(qual), NamedSharding(mesh, P("dp", "sp")))
    out = step(xs, xq)
    jax.block_until_ready(out)
    assert int(jnp.sum(out[-1])) > 0   # per-shard sizes, host-summed


def test_sharded_aligner_matches_host():
    fa = synth_genome(120000, 1)
    ref = refstore.fasta_to_genome(fa, hash_bits=20)
    reads = sample_reads(ref, n_reads=64, read_len=96, mut_rate=0.005)
    col = Col.from_list(reads)
    mat, lens = ragged.to_matrix(col)
    L = mat.shape[1]
    codes = packops.BASE2BIT[mat]

    host = host_aligner.align_batch(ref, codes, lens)

    devs = jax.devices()[:8]
    mesh = jax.sharding.Mesh(np.asarray(devs).reshape(2, 4), ("dp", "mp"))
    slabs, starts, rh = aligner_sharded.shard_genome(ref, 4, L)
    step = aligner_sharded.make_sharded_aligner(mesh, L, ref.hash_bits)
    gpos, fwd, nmm, aligned = jax.block_until_ready(step(
        jnp.asarray(codes), jnp.asarray(lens.astype(np.int32)),
        jnp.asarray(slabs), jnp.asarray(starts.astype(np.uint32)),
        jnp.asarray(rh), jnp.asarray([ref.length], np.uint32)))

    aligned = np.asarray(aligned)
    # the sharded aligner must align essentially everything the host did
    assert aligned.mean() >= np.asarray(host["aligned"]).mean() - 0.02
    both = aligned & host["aligned"]
    # where both align, placements agree (same candidate set, same scoring)
    assert (np.asarray(gpos)[both] == host["gpos"][both]).mean() > 0.98


def test_mesh_fastq_zip_roundtrip(tmp_path):
    """End-to-end FASTQ zip with --mesh (MeshAligner over the virtual
    8-device mesh) must round-trip and actually align most reads."""
    import os
    from genozip_tpu.zip_pipeline import zip_file
    from genozip_tpu.piz_pipeline import piz_file, PizReader

    fa = synth_genome(150000, 1)
    fa_path = os.path.join(str(tmp_path), "mg.fa")
    open(fa_path, "wb").write(fa)
    ref_path = os.path.join(str(tmp_path), "mg.ref.gxz")
    refstore.make_reference(fa_path, ref_path)
    ref = refstore.load_ref_file(ref_path)

    reads = sample_reads(ref, n_reads=1200, read_len=100, mut_rate=0.005)
    out = []
    rng = np.random.default_rng(4)
    for i, r in enumerate(reads):
        q = rng.choice(np.frombuffer(b"FF:,#", np.uint8), len(r)).tobytes()
        out.append(b"@M%d\n" % i + r + b"\n+\n" + q + b"\n")
    data = b"".join(out)
    src = os.path.join(str(tmp_path), "m.fastq")
    open(src, "wb").write(data)
    z = src + ".gxz"
    zip_file(src, z, reference=ref_path, mesh=8)
    o = src + ".out"
    piz_file(z, o, reference=ref_path)
    assert open(o, "rb").read() == data
    # most reads must have gone through the sharded aligner successfully
    pr = PizReader(z, reference=ref_path)
    loaded = pr.load_vb(1, 0)
    sec = loaded[1]
    bm = sec["SQBITMAP"]["local"][0]
    assert bm.astype(bool).mean() > 0.9, f"aligned {bm.mean():.2f}"
    pr.close()


def test_dp_sharded_zip_byte_identical(tmp_path):
    """zip_file(dp=8): VBs data-parallel over the dp mesh axis; the archive
    must equal the single-host archive byte-for-byte, and unzip losslessly."""
    import os
    from genozip_tpu.zip_pipeline import zip_file
    from genozip_tpu.piz_pipeline import piz_file
    rng = np.random.default_rng(77)
    reads = []
    for i in range(4000):
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), 100)
        q = (rng.integers(0, 40, 100) + 33).astype(np.uint8)
        reads.append(b"@x%d\n%s\n+\n%s\n" % (i, s.tobytes(), q.tobytes()))
    data = b"".join(reads)
    src = os.path.join(str(tmp_path), "dp.fastq")
    open(src, "wb").write(data)
    zh, zd = src + ".h.gxz", src + ".d.gxz"
    zip_file(src, zh, vb_size=64 * 1024)
    zip_file(src, zd, vb_size=64 * 1024, dp=8)
    assert open(zh, "rb").read() == open(zd, "rb").read()
    piz_file(zd, src + ".out")
    assert open(src + ".out", "rb").read() == data


def test_collective_dict_merge_matches_host():
    """The dict merge as a collective (context.c:938 analog): all-gathered
    per-VB hash rows -> identical first-seen assignment on every device."""
    from genozip_tpu.parallel import zip_sharded
    rng = np.random.default_rng(31)
    D, W = 8, 48
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:D]), ("dp",))
    hashes = (rng.integers(0, 60, (D, W)).astype(np.uint64)
              * np.uint64(0x9E3779B97F4A7C15))
    valid = rng.random((D, W)) > 0.3
    merge = zip_sharded.make_collective_merge(mesh, W)
    out, nuniq = merge(
        jnp.asarray((hashes >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray(valid))
    ref_lut, nref = zip_sharded.collective_merge_host_twin(hashes, valid)
    assert (np.asarray(out) == ref_lut).all()
    assert int(nuniq) == nref


def test_sharded_aligner_u32_gpos_beyond_2g():
    """>2^31-base genome on the sharded aligner: GPOS arithmetic is pure
    uint32 (round-1 int64-narrowing silently degraded human-scale genomes).
    Synthetic slab starts near 4.2 Gbase; physical slabs stay tiny."""
    from genozip_tpu.ref.refstore import KMER, hash_kmer, NO_GPOS

    rng = np.random.default_rng(5)
    mp, dp = 4, 2
    mesh = jax.sharding.Mesh(
        np.asarray(jax.devices()[: dp * mp]).reshape(dp, mp), ("dp", "mp"))
    L = 64
    slab_phys = 4096 + L + KMER          # physical slab buffer (base + halo)
    G = 4_200_000_000                    # > 2^31, < 2^32
    starts = np.array([0, 1_050_000_000, 2_500_000_000, 4_100_000_000],
                      np.uint64)
    slabs = rng.integers(0, 4, (mp, slab_phys)).astype(np.uint8)

    hash_bits = 20
    rh = np.full(1 << hash_bits, NO_GPOS, np.uint32)
    R = 16 * dp
    codes = np.zeros((R, L), np.uint8)
    true_gpos = np.zeros(R, np.uint64)
    lens = np.full(R, L, np.int32)
    for i in range(R):
        j = i % mp
        d = int(rng.integers(0, 2048))
        codes[i] = slabs[j, d:d + L]
        true_gpos[i] = starts[j] + d
        # register this read's seed kmers in the refhash (first-wins)
        for si in range(4):
            off = (L - KMER) * si // 3
            km = np.uint32(0)
            for b in codes[i, off:off + KMER]:
                km = (km << np.uint32(2)) | np.uint32(b)
            h = int(hash_kmer(np.array([km], np.uint32), hash_bits)[0])
            if rh[h] == NO_GPOS:
                rh[h] = np.uint32((int(true_gpos[i]) + off) & 0xFFFFFFFF)

    per = -(-rh.shape[0] // mp)
    rh_mat = np.full(mp * per, NO_GPOS, np.uint32)
    rh_mat[: rh.shape[0]] = rh
    step = aligner_sharded.make_sharded_aligner(mesh, L, hash_bits)
    gpos, fwd, nmm, aligned = jax.block_until_ready(step(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(slabs),
        jnp.asarray(starts.astype(np.uint32)),
        jnp.asarray(rh_mat.reshape(mp, per)),
        jnp.asarray([G], np.uint32)))
    gpos = np.asarray(gpos).astype(np.uint32).astype(np.uint64)
    aligned = np.asarray(aligned)
    assert aligned.mean() > 0.9, aligned.mean()
    ok = aligned & (gpos == true_gpos)
    assert ok.sum() >= 0.9 * R, (ok.sum(), R)
    assert (gpos[aligned] > np.uint64(1 << 31)).any(), \
        "no >2^31 placements exercised"


def test_piz_dp_byte_identical(tmp_path):
    """dp-sharded PIZ (plan sliced per worker, ordered assembly,
    writer.c:866/1203 roles): output equals host PIZ byte-for-byte,
    including a gencomp-reordered SAM."""
    import numpy as np
    import os
    from genozip_tpu.zip_pipeline import zip_file
    from genozip_tpu.piz_pipeline import piz_file
    from genozip_tpu.parallel.piz_sharded import piz_file_dp
    rng = np.random.default_rng(3)
    reads = []
    for i in range(2000):
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), 100)
        q = (rng.integers(0, 40, 100) + 33).astype(np.uint8)
        reads.append(b"@q%d\n%s\n+\n%s\n" % (i, s.tobytes(), q.tobytes()))
    src = os.path.join(str(tmp_path), "dp.fastq")
    open(src, "wb").write(b"".join(reads))
    zip_file(src, src + ".gxz", vb_size=48 * 1024)
    piz_file(src + ".gxz", src + ".host")
    host = open(src + ".host", "rb").read()
    assert piz_file_dp(src + ".gxz", dp=8) == host
    assert host == b"".join(reads)

    hdr = b"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:c1\tLN:99999\n"
    rows = []
    p = 1
    for i in range(1500):
        p += int(rng.integers(1, 50))
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), 70)
        q = (rng.integers(0, 40, 70) + 33).astype(np.uint8)
        if i % 9 == 2:
            rows.append(b"h%d\t256\tc1\t%d\t0\t70M\t*\t0\t0\t*\t*\n" % (i, p))
        else:
            rows.append(b"h%d\t0\tc1\t%d\t60\t70M\t*\t0\t0\t%s\t%s\n"
                        % (i, p, s.tobytes(), q.tobytes()))
    sam = os.path.join(str(tmp_path), "dp.sam")
    open(sam, "wb").write(hdr + b"".join(rows))
    zip_file(sam, sam + ".gxz", vb_size=32 * 1024)
    piz_file(sam + ".gxz", sam + ".host")
    hosts = open(sam + ".host", "rb").read()
    assert piz_file_dp(sam + ".gxz", dp=8) == hosts
    assert hosts == hdr + b"".join(rows)


def test_sharded_decode_bit_identity():
    """ShardedPizDecoder == rans_np.decode for a dp batch of mixed-size
    order-0 streams sharing a (K, N) lane layout."""
    import numpy as np
    from genozip_tpu.ops import rans_np
    from genozip_tpu.parallel.piz_sharded import ShardedPizDecoder
    rng = np.random.default_rng(4)
    items, raws = [], []
    for i in range(12):
        n = int(rng.integers(50000, 65000))
        data = rng.integers(0, 30, n).astype(np.uint8).tobytes()
        raws.append(data)
        items.append(rans_np.encode(data, 0))
    # plus a tiny one (host fallback path) and an order-1 one
    tiny = bytes(rng.integers(0, 9, 100, np.uint8))
    raws.append(tiny)
    items.append(rans_np.encode(tiny, 0))
    o1 = bytes(rng.integers(0, 9, 20000, np.uint8))
    raws.append(o1)
    items.append(rans_np.encode(o1, 1))
    outs = ShardedPizDecoder(8, min_size=1024).decode_sections(items)
    assert all(o == r for o, r in zip(outs, raws))
