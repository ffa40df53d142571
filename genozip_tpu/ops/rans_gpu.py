"""Batched W32x16 rANS coder for NVIDIA GPUs: Pallas kernels on the Triton
route, bit-exact with the numpy spec (ops/rans_np.py).

One program per stream. The stream's N lanes (16..8192) are the program's
vector, so every lane state stays in registers for all K = ceil(n/N) steps
of the sequential coder loop; XLA's version of the same loop
(ops/rans_jax.py) pays at least one kernel launch per step.

- Tables are gathers from the packed per-stream tables built on the host
  (ops/rans_jax.encode_tables / decode_tables): `etab[key] = freq | cum<<16`
  with key = sym (order 0) or ctx*256 + sym (order 1), and for decode the
  slot->symbol table `s2s` (4096 entries, or 256*4096 for order 1). Order-0
  tables sit in L1; order-1 rows are read through L2.
- Encode walks steps in descending t and compacts in-kernel: each step's
  renorm words go backward into the output, at positions given by an
  inclusive scan of the emit flags over the lanes. The final states are
  written just before the first word, so the stream body is one slice.
- Decode reads each step's renorm words at an exclusive scan of the renorm
  flags, so one stream's lanes live in one program.

A batch groups streams of one (lane count, order); shapes are bucketed so a
run compiles a bounded set of kernels.
"""

import collections
import functools
import threading

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .rans_np import SCALE_BITS, SCALE, RANS_L, choose_num_lanes, lane_layout
from .rans_jax import bucket, encode_tables, decode_tables, header

# launches, sections and bytes coded by this module (read by chip_smoke.py);
# ZIP's seg workers call in concurrently
counts = collections.Counter()
_counts_lock = threading.Lock()


def _count(kind: str, sizes):
    with _counts_lock:
        counts[kind + "_launches"] += 1
        counts[kind + "_sections"] += len(sizes)
        counts[kind + "_bytes"] += int(sum(sizes))

_MAX_BATCH = 64            # streams per kernel launch
_MAX_BATCH_BYTES = 1 << 28  # padded symbols per kernel launch


def _num_warps(N: int) -> int:
    return max(1, min(16, N // 256))


def _enc_kernel(ns_ref, data_ref, tab_ref, out_ref, pos_ref, *, N, order,
                L, W):
    b = pl.program_id(0)
    n = ns_ref[b]
    K = (n + N - 1) // N
    lane = lax.broadcasted_iota(jnp.int32, (N,), 0)
    lane_len = jnp.clip(n - lane * K, 0, K)
    src = b * L + lane * K
    dst = b * W
    T = 65536 if order else 256

    def step(i, carry):
        x, p = carry
        t = K - 1 - i
        act = t < lane_len
        key = plgpu.load(data_ref.at[src + t], mask=act, other=0) \
            .astype(jnp.int32)
        if order:
            ctx = plgpu.load(data_ref.at[src + t - 1], mask=act & (t > 0),
                             other=0)
            key = ctx.astype(jnp.int32) * 256 + key
        e = plgpu.load(tab_ref.at[b * T + key])
        f = jnp.where(act, e & 0xFFFF, 1)
        emit = act & ((x >> 20) >= f)
        e32 = emit.astype(jnp.int32)
        S = jnp.sum(e32)
        # masked-off lanes aim at the row's spare tail, never at a word
        at = jnp.where(emit, p - S + jnp.cumsum(e32) - 1, W - 1)
        plgpu.store(out_ref.at[dst + at], (x & 0xFFFF).astype(jnp.uint16),
                    mask=emit)
        x = jnp.where(emit, x >> 16, x)
        q = x // f
        x = jnp.where(act, (q << SCALE_BITS) + (x - q * f) + (e >> 16), x)
        return x, p - S

    x0 = jnp.full((N,), RANS_L, jnp.uint32)
    x, p = lax.fori_loop(0, K, step, (x0, 2 * N + K * N))
    st = dst + p - 2 * N + 2 * lane
    plgpu.store(out_ref.at[st], (x >> 16).astype(jnp.uint16))
    plgpu.store(out_ref.at[st + 1], (x & 0xFFFF).astype(jnp.uint16))
    pos_ref[b] = p - 2 * N


def _dec_kernel(ns_ref, words_ref, tab_ref, s2s_ref, out_ref, *, N, order,
                L, W):
    b = pl.program_id(0)
    n = ns_ref[b]
    K = (n + N - 1) // N
    lane = lax.broadcasted_iota(jnp.int32, (N,), 0)
    lane_len = jnp.clip(n - lane * K, 0, K)
    src = b * W
    dst = b * L + lane * K
    T, Q = (65536, 256 * SCALE) if order else (256, SCALE)
    hi = plgpu.load(words_ref.at[src + 2 * lane]).astype(jnp.uint32)
    lo = plgpu.load(words_ref.at[src + 2 * lane + 1]).astype(jnp.uint32)

    def step(t, carry):
        x, p, ctx = carry
        act = t < lane_len
        slot = (x & (SCALE - 1)).astype(jnp.int32)
        s = plgpu.load(s2s_ref.at[b * Q + ctx * SCALE + slot]) \
            .astype(jnp.int32)
        e = plgpu.load(tab_ref.at[b * T + ctx * 256 + s])
        f, c = e & 0xFFFF, e >> 16
        x = jnp.where(act, f * (x >> SCALE_BITS) + slot.astype(jnp.uint32)
                      - c, x)
        need = act & (x < RANS_L)
        n32 = need.astype(jnp.int32)
        got = plgpu.load(words_ref.at[src + p + jnp.cumsum(n32) - 1],
                         mask=need, other=0).astype(jnp.uint32)
        x = jnp.where(need, (x << 16) | got, x)
        plgpu.store(out_ref.at[dst + t], s.astype(jnp.uint8), mask=act)
        if order:
            ctx = jnp.where(act, s, ctx)
        return x, p + jnp.sum(n32), ctx

    lax.fori_loop(0, K, step, ((hi << 16) | lo, 2 * N,
                               jnp.zeros((N,), jnp.int32)))


def _enc_row(N: int, L: int) -> int:
    """Encode output row: 2N states + L words + a spare tail."""
    return 2 * N + L + 64


def _params(N):
    return plgpu.CompilerParams(num_warps=_num_warps(N), num_stages=1)


@functools.lru_cache(maxsize=None)
def _encoder(B: int, L: int, N: int, order: int, interpret: bool):
    W = _enc_row(N, L)
    return jax.jit(pl.pallas_call(
        functools.partial(_enc_kernel, N=N, order=order, L=L, W=W),
        grid=(B,),
        out_shape=(jax.ShapeDtypeStruct((B * W,), jnp.uint16),
                   jax.ShapeDtypeStruct((B,), jnp.int32)),
        backend="triton", compiler_params=_params(N), interpret=interpret,
        name=f"rans_encode_o{order}"))


@functools.lru_cache(maxsize=None)
def _decoder(B: int, L: int, W: int, N: int, order: int, interpret: bool):
    return jax.jit(pl.pallas_call(
        functools.partial(_dec_kernel, N=N, order=order, L=L, W=W),
        grid=(B,),
        out_shape=jax.ShapeDtypeStruct((B * L,), jnp.uint8),
        backend="triton", compiler_params=_params(N), interpret=interpret,
        name=f"rans_decode_o{order}"))


def _batches(keys, sizes):
    """Split items into launches: grouped by key, largest first, each
    launch at most _MAX_BATCH streams and _MAX_BATCH_BYTES padded bytes."""
    groups = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    for k, idxs in groups.items():
        idxs.sort(key=lambda i: -sizes[i])
        j = 0
        while j < len(idxs):
            cap = max(1, min(_MAX_BATCH, _MAX_BATCH_BYTES //
                             bucket(sizes[idxs[j]])))
            yield k, idxs[j:j + cap]
            j += cap


def _rows(count: int) -> int:
    """Launch rows: the next power of two (bounded compile set)."""
    return 1 << max(count - 1, 0).bit_length()


def encode_launches(items, n_lanes: int | None = None,
                    interpret: bool = False):
    """Plan encode_many: yields (kernel, host args, finish) per launch;
    finish(*kernel outputs) yields (item index, framed stream)."""
    datas = [np.frombuffer(p, np.uint8) for p, _ in items]
    lanes = [n_lanes or choose_num_lanes(d.shape[0]) for d in datas]
    spans = [lane_layout(d.shape[0], N)[0] * N for d, N in zip(datas, lanes)]
    for (N, order), idxs in _batches(
            [(N, o) for N, (_, o) in zip(lanes, items)], spans):
        B, L = _rows(len(idxs)), bucket(max(spans[i] for i in idxs))
        data = np.zeros((B, L), np.uint8)
        tabs = np.zeros((B, 65536 if order else 256), np.uint32)
        ns = np.zeros(B, np.int32)
        ftabs = []
        for r, i in enumerate(idxs):
            d = datas[i]
            data[r, :d.shape[0]] = d
            ns[r] = d.shape[0]
            tabs[r], ftab = encode_tables(d, N, order)
            ftabs.append(ftab)

        def finish(words, pos, N=N, order=order, idxs=idxs, ns=ns,
                   ftabs=ftabs):
            words = np.asarray(words).reshape(len(ns), -1)
            pos = np.asarray(pos)
            _count("encode", ns[:len(idxs)])
            for r, i in enumerate(idxs):
                body = words[r, pos[r]:2 * N + spans[i]].astype("<u2")
                yield i, header(N, order, ns[r], ftabs[r]) + body.tobytes()
        yield (_encoder(B, L, N, order, interpret),
               (ns, data.ravel(), tabs.ravel()), finish)


def decode_launches(blobs, interpret: bool = False):
    """Plan decode_many: yields (kernel, host args, finish) per launch;
    finish(kernel output) yields (blob index, payload)."""
    parsed = [decode_tables(b) for b in blobs]
    spans = [lane_layout(p[2], p[0])[0] * p[0] for p in parsed]
    for (N, order), idxs in _batches([p[:2] for p in parsed], spans):
        B, L = _rows(len(idxs)), bucket(max(spans[i] for i in idxs))
        W = bucket(max(parsed[i][5].shape[0] for i in idxs))
        T, Q = (65536, 256 * SCALE) if order else (256, SCALE)
        words = np.zeros((B, W), np.uint16)
        tabs = np.zeros((B, T), np.uint32)
        s2s = np.zeros((B, Q), np.uint8)
        ns = np.zeros(B, np.int32)
        for r, i in enumerate(idxs):
            _, _, n, etab, sym, w = parsed[i]
            words[r, :w.shape[0]] = w
            tabs[r], s2s[r], ns[r] = etab, sym, n

        def finish(plane, idxs=idxs, ns=ns):
            plane = np.asarray(plane).reshape(len(ns), -1)
            _count("decode", ns[:len(idxs)])
            for r, i in enumerate(idxs):
                yield i, plane[r, :ns[r]].tobytes()
        yield (_decoder(B, L, W, N, order, interpret),
               (ns, words.ravel(), tabs.ravel(), s2s.ravel()), finish)


def _run(launches, count: int) -> list[bytes]:
    out = [None] * count
    for kernel, args, finish in launches:
        res = kernel(*map(jnp.asarray, args))
        for i, blob in finish(*(res if isinstance(res, tuple) else (res,))):
            out[i] = blob
    return out


def encode_many(items, n_lanes: int | None = None,
                interpret: bool = False) -> list[bytes]:
    """items: (payload, order) pairs -> framed streams, each byte-identical
    to rans_np.encode(payload, order, n_lanes) (lane count from
    choose_num_lanes unless given)."""
    return _run(encode_launches(items, n_lanes, interpret), len(items))


def decode_many(blobs, interpret: bool = False) -> list[bytes]:
    """Framed W32x16 streams (any lane count, order 0 or 1) -> payloads,
    each equal to rans_np.decode(blob)."""
    return _run(decode_launches(blobs, interpret), len(blobs))
