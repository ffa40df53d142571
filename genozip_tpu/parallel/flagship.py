"""Flagship device compute: the jittable FASTQ VB-encode step, single-chip and
multi-chip (shard_map over a Mesh).

A device replacement for the reference's per-VB compute thread
(src/zip.c:510 zip_compress_one_vb): 2-bit SEQ packing (src/codec_acgt.c) +
wide-interleaved rANS of QUAL — with the *global* frequency/stats
reconciliation expressed as collectives (psum over the mesh), the device
analog of the reference's mutex-guarded global context merge
(src/context.c:938 ctx_merge_in_one_vctx). Off the ZIP path: used by
__graft_entry__.py, scaling_bench.py and tests/test_multichip.py.

Mesh axes: 'dp' = data-parallel over reads (VB rows), 'sp' = sequence-parallel
over read positions. Every (dp, sp) block encodes its own set of rANS lanes —
lanes are fully independent, so the only cross-device traffic is the psum'd
histogram; per-shard compressed sizes return sharded and the
host sums them.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map

from ..ops.rans_np import SCALE_BITS, SCALE, RANS_L


def normalize_freqs_jnp(hist):
    """Deterministic device-side histogram -> 2^SCALE_BITS normalization
    (device analog of ops/rans_np.normalize_freqs; self-consistent — the
    table used for encode is the table serialized for decode). int32 math:
    requires per-bin counts < 2^31 / SCALE (~524k); production tables for
    larger VBs are normalized host-side (exact, ops/rans_np)."""
    hist = hist.astype(jnp.int32)
    total = jnp.maximum(jnp.sum(hist), 1)
    f = hist * SCALE // total
    f = jnp.where((hist > 0) & (f == 0), 1, f)
    # distribute the remainder over the largest bins (two rounds of +-1)
    for _ in range(2):
        diff = SCALE - jnp.sum(f)
        sign = jnp.sign(diff)
        order = jnp.argsort(-hist, stable=True)
        rank = jnp.zeros(256, jnp.int32).at[order].set(jnp.arange(256, dtype=jnp.int32))
        eligible = jnp.where(sign >= 0, hist > 0, f > 1)
        take = rank < jnp.abs(diff)
        f = f + jnp.where(take & eligible, sign, 0)
    f = jnp.where(hist.sum() == 0, jnp.zeros(256, jnp.int32).at[0].set(SCALE), f)
    cum = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(f)[:-1]])
    return f.astype(jnp.uint32), cum.astype(jnp.uint32)


def rans_encode_block(syms, freq, cum):
    """Encode a flat uint8 symbol block as (K, N) lanes, all lanes full.
    syms: (K*N,) uint32 in [0,256). Returns (states (N,), words (K,N),
    emits (K,N), nbytes scalar)."""
    n = syms.shape[0]
    N = max(32, min(8192, 1 << int(np.ceil(np.log2(max(n // 64, 1))))))
    K = n // N
    assert K * N == n, "flagship path requires N | n"
    m = syms.reshape(N, K).T  # lane l covers contiguous chunk l

    x0 = jnp.full((N,), RANS_L, dtype=jnp.uint32)

    def step(x, s):
        f = freq[s].astype(jnp.uint32)
        emit = (x >> 20) >= f
        word = (x & 0xFFFF).astype(jnp.uint16)
        x = jnp.where(emit, x >> 16, x)
        x = ((x // f) << SCALE_BITS) + (x % f) + cum[s].astype(jnp.uint32)
        return x, (word, emit)

    x_final, (words, emits) = jax.lax.scan(step, x0, m, reverse=True)
    nbytes = 2 * (2 * N + jnp.sum(emits))
    return x_final, words, emits, nbytes


def pack_seq_2bit(codes):
    """(n,) uint8 2-bit codes -> packed bytes (n/4,)."""
    v = codes.reshape(-1, 4)
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    return jnp.sum((v << shifts).astype(jnp.uint16), axis=1).astype(jnp.uint8)


def fastq_encode_step(seq_codes, qual, freq, cum):
    """Single-chip jittable VB encode: returns (packed_seq, qual_states,
    qual_words, qual_emits, comp_bytes)."""
    packed = pack_seq_2bit(seq_codes.reshape(-1))
    x, w, e, nb = rans_encode_block(qual.reshape(-1).astype(jnp.uint32), freq, cum)
    return packed, x, w, e, nb


def make_mesh(n_devices: int | None = None, devices=None):
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    n = len(devices)
    sp = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // sp
    mesh_devs = np.asarray(devices).reshape(dp, sp)
    return Mesh(mesh_devs, ("dp", "sp"))


def make_sharded_step(mesh: Mesh):
    """Full multi-chip VB encode step: histogram psum (collective stats/dict
    merge) -> device-side freq normalization -> per-shard rANS lanes ->
    sharded per-shard sizes (host-summed)."""

    def local_step(seq_codes, qual):
        q = qual.reshape(-1).astype(jnp.uint32)
        hist_local = jnp.zeros(256, jnp.int32).at[q].add(1)
        # the ONE cross-device sync of the step: the collective dict/stats
        # merge (context.c:938 analog). Per-shard sizes return sharded —
        # the host sums them, so no second collective serializes the tail.
        hist = jax.lax.psum(hist_local, ("dp", "sp"))
        freq, cum = normalize_freqs_jnp(hist)
        packed = pack_seq_2bit(seq_codes.reshape(-1))
        x, w, e, nb = rans_encode_block(q, freq, cum)
        return packed, x, w, e, nb.reshape(1)

    return jax.jit(shard_map(
        local_step, mesh=mesh,
        in_specs=(P("dp", "sp"), P("dp", "sp")),
        out_specs=(P(("dp", "sp")), P(("dp", "sp")), P(None, ("dp", "sp")),
                   P(None, ("dp", "sp")), P(("dp", "sp"))),
        check_rep=False,
    ))


def example_batch(reads=4096, read_len=128, seed=0):
    rng = np.random.default_rng(seed)
    seq_codes = rng.integers(0, 4, (reads, read_len)).astype(np.uint8)
    qual = rng.choice(np.frombuffer(b"FFFFF:F,#", np.uint8), (reads, read_len)).astype(np.uint8)
    hist = np.bincount(qual.reshape(-1), minlength=256)
    from ..ops.rans_np import normalize_freqs
    freq = normalize_freqs(hist)
    cum = np.concatenate([[0], np.cumsum(freq)[:-1]]).astype(np.uint32)
    return seq_codes, qual, freq.astype(np.uint32), cum
