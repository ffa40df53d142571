"""dp-sharded PIZ: reconstruction data-parallel over a device mesh with
plan-ordered assembly.

Reference parity: src/writer.c:866 writer_create_plan (the recon-plan IR)
and :1203 writer_main_loop (ordered assembly thread). The reference
reconstructs VBs on compute threads and a dedicated writer thread emits
them in plan order; here the plan (VB order per component) is sliced
contiguously across dp workers, each worker reconstructs its slice
(the big rANS sections ride ONE dp-sharded jitted decode kernel per
batch — XLA partitions the batch dim over the 'dp' mesh axis), and the
main thread assembles strictly in plan order: gencomp re-interleave,
running digest, output write. Output bytes equal the single-host PIZ
byte-for-byte.
"""

import zlib

import numpy as np

from ..ops import rans_np, rans_jax


class ShardedPizDecoder:
    """Decodes batches of framed rANS streams on a dp mesh; outputs are
    byte-identical to the host decoder (rans_np spec)."""

    def __init__(self, n_devices: int | None = None, min_size: int = 4096):
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        devices = jax.devices()
        self.D = n_devices or len(devices)
        if self.D > len(devices):
            raise ValueError(f"dp={self.D}: only {len(devices)} devices")
        self.mesh = Mesh(np.asarray(devices[: self.D]), ("dp",))
        self.min_size = min_size
        self._P = P
        self._NS = NamedSharding
        self._fns = {}

    def _fn(self, K: int, N: int, order: int):
        key = (K, N, order)
        f = self._fns.get(key)
        if f is None:
            import jax
            sh = self._NS(self.mesh, self._P("dp"))

            def batch(words, ns, tabs, s2s):
                return jax.vmap(lambda w, n, t, q: rans_jax._decode_core(
                    w, n, t, q, K, N, order))(words, ns, tabs, s2s)

            f = self._fns[key] = jax.jit(batch, in_shardings=(sh,) * 4,
                                         out_shardings=sh)
        return f

    def decode_sections(self, items):
        """items: list of framed rANS streams. Streams of at least min_size
        symbols that share the (K, N, order) lane layout batch into ONE
        dp-sharded launch — the batch dim is partitioned over the 'dp' mesh
        axis; smaller ones decode on the host. Returns payload bytes ==
        rans_np.decode for each."""
        import jax.numpy as jnp
        out = [None] * len(items)
        groups = {}
        parsed = [rans_jax.decode_tables(buf) for buf in items]
        for i, (N, order, n, *_) in enumerate(parsed):
            if n < self.min_size:
                out[i] = rans_np.decode(items[i])
                continue
            K = rans_np.lane_layout(n, N)[0]
            groups.setdefault((K, N, order), []).append(i)
        for (K, N, order), idxs in groups.items():
            # pad the batch to a multiple of D for even dp sharding
            Bp = (len(idxs) + self.D - 1) // self.D * self.D
            wb = rans_jax.bucket(max(parsed[i][5].shape[0] for i in idxs))
            wordsb = np.zeros((Bp, wb), "<u2")
            nsb = np.zeros(Bp, np.int32)
            tabb = np.zeros((Bp, parsed[idxs[0]][3].shape[0]), np.uint32)
            s2sb = np.zeros((Bp, parsed[idxs[0]][4].shape[0]), np.uint8)
            for j, i in enumerate(idxs):
                _, _, n, etab, s2s, words = parsed[i]
                wordsb[j, :words.shape[0]] = words
                nsb[j], tabb[j], s2sb[j] = n, etab, s2s
            res = np.asarray(self._fn(K, N, order)(
                jnp.asarray(wordsb), jnp.asarray(nsb), jnp.asarray(tabb),
                jnp.asarray(s2sb)))
            for j, i in enumerate(idxs):
                out[i] = res[j][: parsed[i][2]].tobytes()
        return out


def piz_file_dp(z_path: str, out_path: str | None = None, dp: int = 1,
                reference: str | None = None) -> bytes | None:
    """Data-parallel PIZ: plan VBs fan out round-robin to dp workers with a
    bounded in-flight window; assembly (gencomp re-interleave + digest +
    write) drains strictly in plan order as futures complete, so peak
    memory is O(window × VB), not O(file) (writer_main_loop's streamed
    handover, writer.c:1203). The output is byte-identical to piz_file's."""
    import os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    from ..piz_pipeline import PizReader
    from ..utils import profiler

    pr = PizReader(z_path, reference=reference)
    comps = pr.components()
    has_gencomp = pr.ensure_gencomp()
    sink = open(out_path, "wb") if out_path else None
    chunks = []
    try:
        for comp_i, comp in enumerate(comps):
            nvb = comp.get("num_vbs", pr.num_vbs())
            hdr = pr.txt_header(comp_i) if comp_i == 0 else b""
            adler = zlib.adler32(hdr)
            if sink is not None:
                sink.write(hdr)
            else:
                chunks.append(hdr)

            def work(vb_i):
                loaded = pr.load_vb(vb_i, comp_i)
                with profiler.timer("piz:recon"):
                    return pr.recon_loaded_vb(loaded, vb_i, comp_i,
                                              want_pctxs=True)

            with ThreadPoolExecutor(max_workers=dp) as pool:
                inflight = deque()   # (vb_i, future) in plan order

                def drain():
                    nonlocal adler
                    vb_i, fut = inflight.popleft()
                    out, pctxs = fut.result()
                    if has_gencomp and comp_i == 0:
                        out = pr.merge_vb_gencomp(out, pctxs)
                    adler = zlib.adler32(out, adler)
                    if sink is not None:
                        sink.write(out)
                    else:
                        chunks.append(out)

                for vb_i in range(1, nvb + 1):
                    inflight.append((vb_i, pool.submit(work, vb_i)))
                    if len(inflight) > 2 * dp:
                        drain()
                while inflight:
                    drain()
            comp_adler = comp.get("adler")
            if comp_adler is not None:
                assert adler == comp_adler, \
                    f"component {comp_i}: dp-PIZ digest mismatch"
    except BaseException:
        if sink is not None:
            sink.close()
            os.unlink(out_path)   # never leave a wrong partial output
        raise
    if sink is not None:
        sink.close()
        return None
    return b"".join(chunks)
