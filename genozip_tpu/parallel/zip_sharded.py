"""dp-sharded ZIP: VBs data-parallel over a device mesh.

Reference parity: the reference's only scaling axis is VB data-parallelism
over pthreads (src/dispatcher.c:544) with a mutex-guarded global dict merge
(src/context.c:938). Here:

- ShardedZipEncoder: a batch of VBs' section payloads rides ONE jitted,
  vmapped, dp-sharded kernel (ops/rans_jax._encode_core) — XLA
  partitions the batch dimension over the 'dp' mesh axis, so each device
  entropy-codes its own VB's sections. Output streams are BIT-IDENTICAL to
  the host coder's (rans_np spec), so a dp-N archive equals the
  single-host archive byte-for-byte.

- collective_merge: the dict merge as a collective. Each VB contributes
  its novel-word hash list; hashes are laid out in VB order (the
  deterministic merge order that replaces the reference's vb1-first
  mutex), the jit all-gathers them (P('dp') -> replicated output forces
  XLA to insert the all-gather), and every device computes the
  SAME first-seen global index assignment with a sort + segment-min —
  no host loop.
"""

from functools import partial

import numpy as np

from ..ops import rans_np, rans_jax


def _round_up(x: int, step: int) -> int:
    return ((x + step - 1) // step) * step


class ShardedZipEncoder:
    """Encodes batches of (payload, order) sections on a dp mesh; streams
    are byte-identical to rans_np.encode (host archive equality)."""

    def __init__(self, n_devices: int | None = None, min_size: int = 4096):
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        devices = jax.devices()
        self.D = n_devices or len(devices)
        if self.D > len(devices):
            raise ValueError(f"--dp {self.D}: only {len(devices)} devices")
        self.mesh = Mesh(np.asarray(devices[: self.D]), ("dp",))
        self.min_size = min_size
        self._P = P
        self._NS = NamedSharding
        self._fns = {}

    def eligible(self, payload_len: int) -> bool:
        return payload_len >= self.min_size

    def encode_sections(self, items):
        """items: list of (payload bytes, order). Returns list of framed
        rANS streams == rans_np.encode(payload, order) byte-for-byte."""
        import jax.numpy as jnp
        out = [None] * len(items)
        groups = {}
        for i, (payload, order) in enumerate(items):
            N = rans_np.choose_num_lanes(len(payload))
            groups.setdefault((N, order), []).append(i)
        for (N, order), idxs in groups.items():
            Kmax = _round_up(
                max((len(items[i][0]) + N - 1) // N for i in idxs) or 1, 64)
            rows = _round_up(len(idxs), self.D)
            data = np.zeros((rows, Kmax * N), np.uint8)
            ns = np.zeros(rows, np.int32)
            tabs = np.zeros((rows, 65536 if order else 256), np.uint32)
            ftabs = [b""] * rows
            for r, i in enumerate(idxs):
                payload = np.frombuffer(items[i][0], np.uint8)
                data[r, :payload.shape[0]] = payload
                ns[r] = payload.shape[0]
                tabs[r], ftabs[r] = rans_jax.encode_tables(payload, N, order)
            words, totals = self._fn(Kmax, N, order)(
                jnp.asarray(data), jnp.asarray(ns), jnp.asarray(tabs))
            words = np.asarray(words)
            totals = np.asarray(totals)
            for r, i in enumerate(idxs):
                body = words[r, : int(totals[r])].astype("<u2").tobytes()
                out[i] = rans_jax.header(N, order, ns[r], ftabs[r]) + body
        return out

    def _fn(self, Kmax: int, N: int, order: int):
        key = (Kmax, N, order)
        f = self._fns.get(key)
        if f is None:
            import jax
            sh = self._NS(self.mesh, self._P("dp"))

            def batch(data, ns, tabs):
                return jax.vmap(lambda d, n, t: rans_jax._encode_core(
                    d, n, t, Kmax=Kmax, N=N, order=order))(data, ns, tabs)

            f = self._fns[key] = jax.jit(batch, in_shardings=(sh, sh, sh),
                                         out_shardings=(sh, sh))
        return f


# ---------------------------------------------------------------------------
# collective dictionary merge (context.c:938 as a collective)
# ---------------------------------------------------------------------------

def make_collective_merge(mesh, W: int):
    """Builds the jitted collective merge for (D, W) per-VB hash blocks.
    Input: hi/lo u32 halves of 64-bit word hashes + valid mask, sharded
    P('dp') (each device holds its VB's row). Output: (D, W) global word
    indices, REPLICATED — forcing XLA to all-gather the rows over the mesh;
    assignment order = (vb, local position), the deterministic VB-order
    merge. Also returns the total unique-word count."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    def merge(hi, lo, valid):
        D = hi.shape[0]
        fhi = hi.reshape(-1)
        flo = lo.reshape(-1)
        fva = valid.reshape(-1)
        n = fhi.shape[0]
        pos = jnp.arange(n, dtype=jnp.int32)
        # invalid entries sort last and never define groups
        shi = jnp.where(fva, fhi, jnp.uint32(0xFFFFFFFF))
        slo = jnp.where(fva, flo, jnp.uint32(0xFFFFFFFF))
        order = jnp.lexsort((pos, slo, shi))
        ghi, glo, gva = shi[order], slo[order], fva[order]
        newgrp = jnp.concatenate([
            jnp.ones(1, bool),
            (ghi[1:] != ghi[:-1]) | (glo[1:] != glo[:-1])])
        gid = jnp.cumsum(newgrp) - 1                    # group id per element
        first_pos = jax.ops.segment_min(order, gid, num_segments=n)
        # global index of a group = rank of its first-seen position
        grp_valid = jax.ops.segment_max(gva.astype(jnp.int32), gid,
                                        num_segments=n) > 0
        fp = jnp.where(grp_valid, first_pos, n)
        rank = jnp.argsort(jnp.argsort(fp))             # dense ranks by pos
        elem_gidx = rank[gid]
        out = jnp.zeros(n, jnp.int32).at[order].set(elem_gidx.astype(jnp.int32))
        out = jnp.where(fva, out, -1)
        n_unique = jnp.sum(newgrp & gva)
        return out.reshape(D, W), n_unique

    sh_in = NamedSharding(mesh, P("dp"))
    sh_out = NamedSharding(mesh, P())    # replicated -> all-gather inserted
    return jax.jit(merge, in_shardings=(sh_in, sh_in, sh_in),
                   out_shardings=(sh_out, sh_out))


def collective_merge_host_twin(hash_rows: np.ndarray,
                               valid: np.ndarray):
    """Numpy twin of the collective merge (same first-seen semantics) for
    equivalence tests vs ZCtxGlobal.merge_words."""
    flat = hash_rows.reshape(-1)
    fva = valid.reshape(-1)
    out = np.full(flat.shape[0], -1, np.int64)
    seen = {}
    for i in np.nonzero(fva)[0]:
        h = int(flat[i])
        j = seen.get(h)
        if j is None:
            j = len(seen)
            seen[h] = j
        out[i] = j
    return out.reshape(hash_rows.shape), len(seen)
