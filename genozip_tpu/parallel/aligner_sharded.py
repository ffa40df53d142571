"""Multi-chip sharded seed-hash aligner (jnp twin of ref/aligner.py).

Sharding design (the scaling-book recipe: pick a mesh, annotate shardings,
let XLA insert the collectives):
  - mesh ('dp', 'mp'): reads are data-parallel over 'dp'; the genome and the
    refhash — the multi-GB state — are sharded over 'mp'.
  - refhash lookup: slot h is owned by exactly one 'mp' rank
    (h // slots_per_shard); each rank answers its own slots and a psum over
    'mp' broadcasts the hit to everyone (device all-reduce, no host).
  - genome window scoring: each rank holds a contiguous genome slab plus a
    read-length halo; a candidate's window lives in exactly one slab, that
    rank scores it, and a psum over 'mp' reconciles.
This replaces the reference's serial hook-scan + shared-memory genome
(src/aligner.c, src/ref_cache.c) with pure-collective state sharding.

GPOS arithmetic is pure uint32 (no jnp int64, which silently narrows to
int32 without x64): candidates compare as `start <= gtotal - lens` with an
explicit underflow guard on `g - off`, and the sentinel for "no placement"
is 0xFFFFFFFF. This supports genomes up to ~4.29 Gbase (the reference's
4-byte refhash entries have the same ceiling; its 5-byte layer is the
>4 Gbase extension) — in particular the >2^31 human-scale genomes that the
round-1 int64-narrowing version silently degraded on.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from ..ref.refstore import KMER, FIB32, NO_GPOS


def shard_genome(ref, mp: int, max_read_len: int):
    """Split genome codes into mp contiguous slabs with halo; pad refhash to
    a multiple of mp. Returns (slabs (mp, slab+halo) u8, slab_starts (mp,),
    refhash_mat (mp, slots/mp) u32)."""
    G = ref.length
    slab = -(-G // mp)
    halo = max_read_len + KMER
    slabs = np.zeros((mp, slab + halo), dtype=np.uint8)
    starts = np.zeros(mp, dtype=np.int64)
    for j in range(mp):
        s = j * slab
        e = min(s + slab + halo, G)
        slabs[j, : e - s] = ref.codes[s:e]
        starts[j] = s
    # layer 0 only on the mesh path (the layered table is [l0 | l1] flat;
    # owner-rank routing assumes slot space == 2^hash_bits)
    nslots = 1 << ref.hash_bits
    per = -(-nslots // mp)
    rh = np.full(mp * per, NO_GPOS, dtype=np.uint32)
    rh[:nslots] = ref.refhash[:nslots]
    return slabs, starts, rh.reshape(mp, per)


def make_sharded_aligner(mesh: Mesh, L: int, hash_bits: int,
                         num_seeds: int = 4):
    """Returns a jitted (codes (R, L) u8 sharded dp, lens (R,), slabs, starts,
    refhash) -> (gpos, is_fwd, nmm, aligned) aligner step."""
    mp = mesh.shape["mp"]

    def local(codes, lens, slabs, starts, rh, gtotal):
        # local shapes: codes (r, L); slabs (1, slab+halo); rh (1, per)
        codes = codes.astype(jnp.uint32)
        r = codes.shape[0]
        slab_codes = slabs[0].astype(jnp.uint32)
        rh_local = rh[0]
        per = rh_local.shape[0]
        my_mp = jax.lax.axis_index("mp")
        slot_base = my_mp * per
        slab_start = starts[0]
        slab_len = slab_codes.shape[0]

        lens = lens.astype(jnp.int32)
        pos_idx = jax.lax.broadcasted_iota(jnp.int32, (r, L), 1)
        valid = pos_idx < lens[:, None]

        # reverse-complement rows
        comp = codes ^ 3
        ridx = jnp.clip(lens[:, None] - 1 - pos_idx, 0, L - 1)
        rc = jnp.take_along_axis(comp, ridx, axis=1)

        NOPOS = jnp.uint32(0xFFFFFFFF)
        best_nmm = jnp.full((r,), 1 << 30, dtype=jnp.int32)
        best_gpos = jnp.full((r,), NOPOS, dtype=jnp.uint32)
        best_fwd = jnp.ones((r,), dtype=jnp.bool_)
        gtotal_u = gtotal[0].astype(jnp.uint32)
        lens_u = lens.astype(jnp.uint32)
        slab_start_u = slab_start.astype(jnp.uint32)

        for direction, mat in ((1, codes), (0, rc)):
            for si in range(num_seeds):
                off = (lens - KMER) * si // max(num_seeds - 1, 1)
                off = jnp.clip(off, 0, jnp.maximum(lens - KMER, 0))
                idx = jnp.clip(off[:, None] + jnp.arange(KMER)[None, :], 0, L - 1)
                window = jnp.take_along_axis(mat, idx, axis=1)
                km = jnp.zeros((r,), dtype=jnp.uint32)
                for j in range(KMER):
                    km = (km << np.uint32(2)) | window[:, j].astype(jnp.uint32)
                h = ((km * FIB32) >> np.uint32(32 - hash_bits)).astype(jnp.int32)
                # sharded refhash lookup: owner answers, psum broadcasts
                owned = (h >= slot_base) & (h < slot_base + per)
                g_local = jnp.where(
                    owned, rh_local[jnp.where(owned, h - slot_base, 0)], 0)
                g = jax.lax.psum(g_local.astype(jnp.uint32), "mp")
                miss = g == NO_GPOS
                # pure u32 GPOS: underflow guard instead of signed math
                offu = off.astype(jnp.uint32)
                neg = offu > g
                start = g - offu            # u32, wraps iff neg (guarded)
                cand_ok = ~miss & ~neg & (start <= gtotal_u - lens_u) & \
                    (lens_u <= gtotal_u)
                # sharded scoring: unique owner = slab whose BASE region
                # (excluding halo) contains `start`; halo >= L+KMER ensures
                # the whole window is resident there
                base_len = jnp.uint32(slab_len - (L + KMER))
                rel = start - slab_start_u   # u32, wraps if start<slab_start
                in_slab = (start >= slab_start_u) & (rel < base_len)
                lstart = jnp.where(in_slab & cand_ok, rel, 0).astype(jnp.int32)
                gi = jnp.clip(lstart[:, None] + pos_idx, 0, slab_len - 1)
                gwin = slab_codes[gi]
                mm_loc = jnp.sum((gwin != mat) & valid, axis=1).astype(jnp.int32)
                mm_loc = jnp.where(in_slab & cand_ok, mm_loc, 0)
                have = (in_slab & cand_ok).astype(jnp.int32)
                mm = jax.lax.psum(mm_loc, "mp")
                have = jax.lax.psum(have, "mp")
                mm = jnp.where(have > 0, mm, 1 << 30)
                better = mm < best_nmm
                best_nmm = jnp.where(better, mm, best_nmm)
                best_gpos = jnp.where(better, start, best_gpos)
                best_fwd = jnp.where(better, direction == 1, best_fwd)

        aligned = (best_nmm <= (lens // 2)) & (best_gpos != NOPOS)
        return (best_gpos, best_fwd, jnp.where(aligned, best_nmm, 0),
                aligned)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("dp", None), P("dp"), P("mp", None), P("mp"), P("mp", None), P()),
        out_specs=(P("dp"), P("dp"), P("dp"), P("dp")),
        check_rep=False,
    ))
