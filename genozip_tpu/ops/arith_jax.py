"""ARITH-W32 adaptive range coder — JAX/XLA device implementation.

Bit-exact with the numpy spec in ops/arith_np.py (reference role:
src/htscodecs/arith_dynamic.c). The lockstep design maps 1:1 onto a
lax.scan over steps: the carry holds the N lane coder states (low, range,
code) AND the shared adaptive model ((nctx, 256) u32 freqs + totals); every
step is wide vector ops — a cumsum for the model tables, one-hot selects
for per-lane (f, cum), a fixed-unroll masked renorm (a 32-bit low can emit
at most 4 bytes per symbol), and a scatter-add batched model update.
Renorm byte planes come back (K, R, N); the host compacts them into the
decoder-order stream with the shared arith_np.assemble_stream.

Throughput note: order-1's per-step (N, 256) cumsum makes this
bandwidth-bound on the model tables; a device use would batch many streams
into one kernel, as ops/rans_gpu.py does for rANS.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import arith_np
from .arith_np import INC, MAX_TOTAL, choose_num_lanes, _lane_layout

# Max renorm iterations per symbol: adjust cascades can fire at most while
# low's shifted-in bits are nonzero (4 iterations drain a 32-bit low), after
# which rng >= 1 grows 256x/iteration to >= TOP in 3 more; 8 is a safe bound
# (empirical max over adversarial corpora: 3). Extra iterations are masked
# no-ops, so bit-exactness never depends on this constant.
R_MAX = 8
TOP = np.uint32(1 << 24)
BOT = np.uint32(1 << 16)


def _iota2(n, m, dim):
    return jax.lax.broadcasted_iota(jnp.int32, (n, m), dim)


def _lane_matrix(data_u8, K: int, N: int):
    n = data_u8.shape[0]
    pad = K * N - n
    padded = jnp.concatenate([data_u8, jnp.zeros(pad, jnp.uint8)])
    m = padded.reshape(N, K).T.astype(jnp.int32)
    lane_len = jnp.clip(n - _iota2(K, N, 1) * K, 0, K)
    active = _iota2(K, N, 0) < lane_len
    return m, active


def _model_rows(freq, total, ctx, order):
    """Per-lane inclusive-cum rows + totals for this step's contexts."""
    if order == 0:
        cums = jnp.cumsum(freq[0], dtype=jnp.uint32)
        rows_c = jnp.broadcast_to(cums, (ctx.shape[0], 256))
        tot = jnp.broadcast_to(total[0], (ctx.shape[0],))
    else:
        rows = freq[ctx]                     # (N, 256) gather by context
        rows_c = jnp.cumsum(rows, axis=1, dtype=jnp.uint32)
        tot = total[ctx]
    return rows_c, tot


def _select_sym(rows_c, sym):
    """(f, cum_exclusive) of each lane's symbol via one-hot selects."""
    oh = (sym[:, None] == _iota2(1, 256, 1)).astype(jnp.uint32)
    inc = jnp.sum(rows_c * oh, axis=1)
    prev = jnp.concatenate([jnp.zeros((rows_c.shape[0], 1), jnp.uint32),
                            rows_c[:, :-1]], axis=1)
    exc = jnp.sum(prev * oh, axis=1)
    return inc - exc, exc


def _model_update(freq, total, ctx, sym, active, order):
    c = jnp.where(active, ctx if order else jnp.zeros_like(ctx), 0)
    s = jnp.where(active, sym, 0)
    d = jnp.where(active, jnp.uint32(INC), jnp.uint32(0))
    freq = freq.at[c, s].add(d)
    total = total.at[c].add(d)
    over = total > MAX_TOTAL     # one halving suffices: N*INC < MAX_TOTAL
    freq = jnp.where(over[:, None], (freq + 1) >> 1, freq)
    total = jnp.where(over, freq.sum(axis=1, dtype=jnp.uint32), total)
    return freq, total


@partial(jax.jit, static_argnames=("K", "N", "order"))
def _encode_device(data_u8, K: int, N: int, order: int):
    m, active = _lane_matrix(data_u8, K, N)
    ctx_m = jnp.concatenate([jnp.zeros((1, N), jnp.int32), m[:-1]], axis=0) \
        if order else jnp.zeros_like(m)
    nctx = 256 if order else 1
    freq0 = jnp.ones((nctx, 256), jnp.uint32)
    total0 = jnp.full((nctx,), 256, jnp.uint32)
    low0 = jnp.zeros((N,), jnp.uint32)
    rng0 = jnp.full((N,), 0xFFFFFFFF, jnp.uint32)

    def step(carry, inp):
        low, rng, freq, total = carry
        sym, act, ctx = inp
        rows_c, tot = _model_rows(freq, total, ctx, order)
        f, c = _select_sym(rows_c, sym)
        r = jnp.where(act, rng // jnp.maximum(tot, 1), rng)
        low = jnp.where(act, low + c * r, low)
        rng = jnp.where(act, f * r, rng)
        bytes_out, emits = [], []
        for _ in range(R_MAX):
            c1 = (low ^ (low + rng)) < TOP
            c2 = rng < BOT
            go = act & (c1 | c2)
            adj = go & ~c1
            rng = jnp.where(adj, (jnp.uint32(0) - low) & (BOT - jnp.uint32(1)), rng)
            bytes_out.append((low >> 24).astype(jnp.uint8))
            emits.append(go)
            low = jnp.where(go, low << 8, low)
            rng = jnp.where(go, rng << 8, rng)
        freq, total = _model_update(freq, total, ctx, sym, act, order)
        return (low, rng, freq, total), (jnp.stack(bytes_out), jnp.stack(emits))

    (low_f, _, _, _), (byts, emits) = jax.lax.scan(
        step, (low0, rng0, freq0, total0), (m, active, ctx_m))
    return low_f, byts, emits           # (K, R, N) planes


@partial(jax.jit, static_argnames=("K", "N", "n", "order"))
def _decode_device(body, K: int, N: int, n: int, order: int):
    init = body[: 4 * N].reshape(N, 4).astype(jnp.uint32)
    code0 = (init[:, 0] << 24) | (init[:, 1] << 16) | (init[:, 2] << 8) | init[:, 3]
    ptr0 = jnp.uint32(4 * N)
    lane_len = jnp.clip(n - _iota2(K, N, 1) * K, 0, K)
    active = _iota2(K, N, 0) < lane_len
    nctx = 256 if order else 1
    freq0 = jnp.ones((nctx, 256), jnp.uint32)
    total0 = jnp.full((nctx,), 256, jnp.uint32)
    low0 = jnp.zeros((N,), jnp.uint32)
    rng0 = jnp.full((N,), 0xFFFFFFFF, jnp.uint32)
    prev0 = jnp.zeros((N,), jnp.int32)

    def step(carry, act):
        low, rng, code, ptr, prev, freq, total = carry
        ctx = prev if order else jnp.zeros_like(prev)
        rows_c, tot = _model_rows(freq, total, ctx, order)
        tot = jnp.maximum(tot, 1)
        r = rng // tot
        v = jnp.minimum((code - low) // jnp.maximum(r, 1), tot - 1)
        sym = jnp.sum((rows_c <= v[:, None]).astype(jnp.int32), axis=1)
        sym = jnp.clip(sym, 0, 255)
        f, c = _select_sym(rows_c, sym)
        low = jnp.where(act, low + c * r, low)
        rng = jnp.where(act, f * r, rng)
        for _ in range(R_MAX):
            c1 = (low ^ (low + rng)) < TOP
            c2 = rng < BOT
            go = act & (c1 | c2)
            adj = go & ~c1
            rng = jnp.where(adj, (jnp.uint32(0) - low) & (BOT - jnp.uint32(1)), rng)
            rank = jnp.cumsum(go.astype(jnp.uint32))
            got = body[jnp.where(go, ptr + rank - 1, 0)].astype(jnp.uint32)
            code = jnp.where(go, (code << 8) | got, code)
            ptr = ptr + rank[-1]
            low = jnp.where(go, low << 8, low)
            rng = jnp.where(go, rng << 8, rng)
        freq, total = _model_update(freq, total, ctx, sym, act, order)
        out = jnp.where(act, sym, 0).astype(jnp.uint8)
        prev = jnp.where(act, sym, prev)
        return (low, rng, code, ptr, prev, freq, total), out

    _, out = jax.lax.scan(
        step, (low0, rng0, code0, ptr0, prev0, freq0, total0), active)
    return out.T.reshape(-1)[:n]


def encode(data, order: int = 0, n_lanes: int | None = None) -> bytes:
    data = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    N = n_lanes or choose_num_lanes(n)
    assert N * INC < MAX_TOTAL, "one-halving rescale bound"
    K = (n + N - 1) // N if n else 0
    header = bytes([int(np.log2(N)), order]) + int(n).to_bytes(4, "little")
    if K == 0:
        return arith_np.encode(data, order=order, n_lanes=N)
    low_f, byts, emits = _encode_device(jnp.asarray(data), K, N, order)
    low_f = np.asarray(low_f)
    byts = np.asarray(byts).reshape(-1)       # (K*R*N,)
    emits = np.asarray(emits).reshape(-1)
    ev_byte = byts[emits]
    ev_lane = np.tile(np.arange(N), K * R_MAX)[emits].astype(np.int64)
    flush = np.empty((N, 4), dtype=np.uint8)
    for k in range(4):
        flush[:, k] = (low_f >> 24).astype(np.uint8)
        low_f = (low_f << np.uint32(8)).astype(np.uint32)
    return header + arith_np.assemble_stream(ev_lane, ev_byte, flush, N)


def decode(buf) -> bytes:
    buf = memoryview(buf)
    logN, order = buf[0], buf[1]
    N = 1 << logN
    n = int.from_bytes(buf[2:6], "little")
    K, _ = _lane_layout(n, N)
    if K == 0:
        return b""
    body = np.frombuffer(buf[6:], dtype=np.uint8)
    # bounded shape buckets for the compile cache (decoder never reads past
    # its own consumption; padding is unreachable)
    wb = 1 << 12
    while wb < body.shape[0]:
        wb = wb + (wb >> 1) if wb + (wb >> 1) >= body.shape[0] else wb << 1
    if wb > body.shape[0]:
        body = np.concatenate([body, np.zeros(wb - body.shape[0], np.uint8)])
    out = _decode_device(jnp.asarray(body), K, N, n, int(order))
    return np.asarray(out).tobytes()
