"""MeshAligner: drop-in multi-chip replacement for ref/aligner.align_batch.

Holds the genome + refhash sharded over the mesh's 'mp' axis (device-resident
across VBs — the reference's shared-memory genome cache, src/ref_cache.c,
becomes sharded device state), dispatches read batches data-parallel over
'dp', and returns host arrays with align_batch's contract. Mismatch channels
stay host-side (they're exact regardless of which candidate the aligner
picked, so device/host divergence can never corrupt data — only ratio).

Used by the FASTQ zip path behind --mesh N (genozip has no multi-device
equivalent; SURVEY.md §2 parallelism note)."""

import numpy as np

from ..ref.refstore import RefGenome


def _bucket(n: int, step: int) -> int:
    return max(((n + step - 1) // step) * step, step)


class MeshAligner:
    def __init__(self, ref: RefGenome, n_devices: int | None = None,
                 mp: int | None = None, max_read_len: int = 1024):
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from . import aligner_sharded

        devices = jax.devices()
        nd = n_devices or len(devices)
        if nd > len(devices):
            raise ValueError(f"--mesh {nd}: only {len(devices)} devices")
        mp = mp or max(nd // 2, 1)
        dp = max(nd // mp, 1)
        self.dp, self.mp = dp, mp
        self.mesh = Mesh(np.asarray(devices[: dp * mp]).reshape(dp, mp),
                         ("dp", "mp"))
        self.max_read_len = max_read_len
        slabs, starts, rh = aligner_sharded.shard_genome(ref, mp, max_read_len)
        import jax.numpy as jnp
        sh_mp = NamedSharding(self.mesh, P("mp", None))
        sh_mp1 = NamedSharding(self.mesh, P("mp"))
        self.slabs = jax.device_put(jnp.asarray(slabs), sh_mp)
        self.starts = jax.device_put(jnp.asarray(starts.astype(np.uint32)),
                                     sh_mp1)
        self.rh = jax.device_put(jnp.asarray(rh), sh_mp)
        self.gtotal = jnp.asarray([ref.length], np.uint32)
        self.hash_bits = ref.hash_bits
        self._fns = {}
        self._P = P
        self._NamedSharding = NamedSharding

    def _fn(self, L: int):
        f = self._fns.get(L)
        if f is None:
            from . import aligner_sharded
            f = self._fns[L] = aligner_sharded.make_sharded_aligner(
                self.mesh, L, self.hash_bits)
        return f

    def align_batch(self, ref, codes_mat: np.ndarray, lens: np.ndarray,
                    num_seeds: int = 4):
        """Same contract as ref/aligner.align_batch (host in, host out)."""
        import jax
        import jax.numpy as jnp
        R, L = codes_mat.shape
        if R == 0 or ref.length < 16:
            z = np.zeros(R, dtype=bool)
            return {"aligned": z, "gpos": np.zeros(R, np.int64),
                    "is_fwd": np.ones(R, bool), "nmm": np.zeros(R, np.int32)}
        Lb = _bucket(L, 128)
        assert Lb <= self.max_read_len, \
            f"reads longer than mesh halo ({L} > {self.max_read_len})"
        Rb = _bucket(R, 8 * self.dp)
        cm = np.zeros((Rb, Lb), np.uint8)
        cm[:R, :L] = codes_mat
        lv = np.zeros(Rb, np.int32)
        lv[:R] = lens
        sh = self._NamedSharding(self.mesh, self._P("dp", None))
        sh1 = self._NamedSharding(self.mesh, self._P("dp"))
        xc = jax.device_put(jnp.asarray(cm), sh)
        xl = jax.device_put(jnp.asarray(lv), sh1)
        gpos, fwd, nmm, aligned = self._fn(Lb)(
            xc, xl, self.slabs, self.starts, self.rh, self.gtotal)
        # u32 GPOS (sentinel 0xFFFFFFFF) -> host int64
        gpos_u = np.asarray(gpos)[:R].astype(np.uint32)
        fwd = np.asarray(fwd)[:R].astype(bool)
        nmm = np.asarray(nmm)[:R].astype(np.int32)
        aligned = np.asarray(aligned)[:R].astype(bool)
        gpos = np.where(gpos_u == 0xFFFFFFFF, -1,
                        gpos_u.astype(np.int64))
        # defensive bounds (ratio-only decisions; recon derives from channels)
        bad = aligned & ((gpos < 0) | (gpos + lens > ref.length))
        aligned &= ~bad
        return {"aligned": aligned, "gpos": gpos, "is_fwd": fwd, "nmm": nmm}
