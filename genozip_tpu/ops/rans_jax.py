"""Wide-interleaved rANS — plain JAX/XLA coder, bit-exact with the numpy
reference model in ops/rans_np.py (the normative spec).

This is the device coder of the dp-sharded paths (parallel/zip_sharded.py,
parallel/piz_sharded.py, vmapped over a batch of streams) and the plain
twin that the Pallas kernels of ops/rans_gpu.py are measured against.

- Host->device traffic is raw u8 symbols plus one packed table per stream
  (`etab[key] = freq | cum << 16`, key = sym or ctx*256 + sym); decode also
  takes the slot->symbol table (`s2s[key]`, key = slot or ctx*4096 + slot).
  Every lookup is an integer gather, so no float precision is involved.
- Encode gathers (freq, cum) for the whole (K, N) lane matrix before the
  step loop, since they do not depend on the coder state; the scan itself
  is integer arithmetic and a masked renorm emit. A flip-free cumsum and
  scatter then compacts the words into decoder read order.
- Decode is a scan over steps; each step's renorm reads come from an
  exclusive scan of the renorm flags over the lanes, so the stream layout
  has zero per-lane overhead (cf. interleaved entropy coders,
  arXiv:1402.3392).

Everything fits in uint32: after renorm x < freq<<20, so
((x//f)<<12)+(x%f)+c <= 2^32-1; on decode f*(x>>12) < 2^12 * 2^20.
"""

import zlib

import numpy as np
import jax
import jax.numpy as jnp

from .rans_np import SCALE_BITS, SCALE, RANS_L, choose_num_lanes, \
    lane_layout, normalize_freqs, _freqs_serialize, _freqs_deserialize


# ---------------------------------------------------------------------------
# host tables in the packed form every device coder takes
# ---------------------------------------------------------------------------

def _pack(freq, cum):
    return (freq.astype(np.uint32) | (cum.astype(np.uint32) << 16)).ravel()


def _cum(freq):
    return (np.cumsum(freq, axis=-1) - freq).astype(np.uint32)


def encode_tables(data: np.ndarray, N: int, order: int):
    """(etab, ftab) for encoding `data` with N lanes: the packed u32 table
    (256 entries, or 65536 for order 1) and the serialized frequency
    header, byte-identical to rans_np.encode's."""
    if order == 0:
        freq = normalize_freqs(np.bincount(data, minlength=256))
        return _pack(freq, _cum(freq)), _freqs_serialize(freq)
    n = data.shape[0]
    K = lane_layout(n, N)[0]
    # order-1 context: previous byte within the lane's chunk, 0 at chunk starts
    ctx = np.empty(n, np.int64)
    ctx[1:] = data[:-1]
    ctx[::K or 1] = 0
    hist2 = np.bincount(ctx * 256 + data, minlength=65536).reshape(256, 256)
    freq2 = np.zeros((256, 256), np.uint32)
    used = np.nonzero(hist2.sum(axis=1) > 0)[0]
    for c in used:
        freq2[c] = normalize_freqs(hist2[c])
    parts = [np.packbits(hist2.sum(axis=1) > 0, bitorder="little").tobytes()]
    parts += [_freqs_serialize(freq2[c]) for c in used]
    raw = b"".join(parts)
    comp = zlib.compress(raw, 6)
    ftab = len(raw).to_bytes(4, "little") + len(comp).to_bytes(4, "little") \
        + comp
    return _pack(freq2, _cum(freq2)), ftab


def decode_tables(buf):
    """Parse a stream header -> (N, order, n, etab, s2s, words)."""
    buf = memoryview(buf)
    N, order = 1 << buf[0], buf[1]
    n = int.from_bytes(buf[2:6], "little")
    if order == 0:
        freq, off = _freqs_deserialize(buf, 6)
        s2s = np.repeat(np.arange(256, dtype=np.uint8), freq)
        etab = _pack(freq, _cum(freq))
    else:
        clen = int.from_bytes(buf[10:14], "little")
        raw = memoryview(zlib.decompress(bytes(buf[14:14 + clen])))
        off = 14 + clen
        used = np.nonzero(np.unpackbits(np.frombuffer(raw[:32], np.uint8),
                                        bitorder="little"))[0]
        freq2 = np.zeros((256, 256), np.uint32)
        o2 = 32
        for c in used:
            freq2[c], o2 = _freqs_deserialize(raw, o2)
        s2s = np.zeros((256, SCALE), np.uint8)
        s2s[used] = np.repeat(np.tile(np.arange(256, dtype=np.uint8),
                                      used.shape[0]),
                              freq2[used].ravel()).reshape(-1, SCALE)
        s2s = s2s.ravel()
        etab = _pack(freq2, _cum(freq2))
    words = np.frombuffer(buf[off:], dtype="<u2")
    return N, order, n, etab, s2s, words


def bucket(n: int) -> int:
    """Round up to 2^k or 1.5*2^k (at least 4096), so device code sees a
    bounded set of shapes with at most a third of padding."""
    b = 1 << 12
    while b < n:
        if b + (b >> 1) >= n:
            return b + (b >> 1)
        b <<= 1
    return b


def header(N: int, order: int, n: int, ftab: bytes) -> bytes:
    return bytes([N.bit_length() - 1, order]) + int(n).to_bytes(4, "little") \
        + ftab


# ---------------------------------------------------------------------------
# device cores (n may be traced: the lane layout is dynamic, shapes are not)
# ---------------------------------------------------------------------------

def _encode_core(data_u8, n, etab, Kmax: int, N: int, order: int):
    """Encode the first n symbols of data_u8 -> (words, total): the (2N +
    Kmax*N,) u16 stream body (states, then renorm words in decoder read
    order) and its length. Bit-exact with rans_np.encode for the true n:
    the chunk length is Kc = ceil(n/N) and steps t >= lane_len are masked."""
    Kc = (n + N - 1) // N
    t_i = jax.lax.broadcasted_iota(jnp.int32, (Kmax, N), 0)
    l_i = jax.lax.broadcasted_iota(jnp.int32, (Kmax, N), 1)
    gidx = l_i * Kc + t_i
    last = data_u8.shape[0] - 1
    active = t_i < jnp.clip(n - l_i * Kc, 0, Kc)
    key = jnp.where(active, data_u8[jnp.clip(gidx, 0, last)], 0) \
        .astype(jnp.int32)
    if order == 1:
        ctx = jnp.where(active & (t_i >= 1),
                        data_u8[jnp.clip(gidx - 1, 0, last)], 0)
        key = ctx.astype(jnp.int32) * 256 + key
    e = etab[key]
    f = jnp.where(active, e & 0xFFFF, 1)
    c = e >> 16

    def step(x, inp):
        f, c, act = inp
        emit = act & ((x >> 20) >= f)
        word = (x & 0xFFFF).astype(jnp.uint16)
        x = jnp.where(emit, x >> 16, x)
        q = x // f
        x = jnp.where(act, (q << SCALE_BITS) + (x - q * f) + c, x)
        return x, (word, emit)

    x0 = jnp.full((N,), RANS_L, dtype=jnp.uint32)
    x_final, (words, emits) = jax.lax.scan(step, x0, (f, c, active),
                                           reverse=True)
    # dense compaction into decoder read order (step-asc, lane-asc)
    flat_e = emits.reshape(-1)
    pos = jnp.cumsum(flat_e) - 1
    total = 2 * N + (pos[-1] + 1)
    out = jnp.zeros((2 * N + Kmax * N,), dtype=jnp.uint16)
    st = jnp.stack([(x_final >> 16).astype(jnp.uint16),
                    (x_final & 0xFFFF).astype(jnp.uint16)], axis=1)
    out = out.at[:2 * N].set(st.reshape(-1))
    idx = jnp.where(flat_e, 2 * N + pos, out.shape[0])
    out = out.at[idx].set(words.reshape(-1), mode="drop")
    return out, total


def _decode_core(words_u16, n, etab, s2s, K: int, N: int, order: int):
    """Decode -> the (K*N,) lane plane in symbol order (first n valid);
    `n` may be traced, so a dp-sharded batch can mix streams of nearby
    sizes that share the (K, N) lane layout (parallel/piz_sharded.py)."""
    words = words_u16.astype(jnp.uint32)
    st = words[: 2 * N].reshape(-1, 2)
    x0 = (st[:, 0] << 16) | st[:, 1]
    lane_len = jnp.clip(n - jax.lax.broadcasted_iota(jnp.int32, (K, N), 1)
                        * K, 0, K)
    active = jax.lax.broadcasted_iota(jnp.int32, (K, N), 0) < lane_len

    def step(carry, act):
        x, p, ctx = carry
        slot = x & (SCALE - 1)
        s = s2s[ctx * SCALE + slot].astype(jnp.uint32)
        e = etab[ctx * 256 + s]
        f, c = e & 0xFFFF, e >> 16
        x = jnp.where(act, f * (x >> SCALE_BITS) + slot - c, x)
        need = act & (x < RANS_L)
        rank = jnp.cumsum(need.astype(jnp.uint32))
        got = words[jnp.where(need, p + rank - 1, 0)]
        x = jnp.where(need, (x << 16) | got, x)
        if order == 1:
            ctx = jnp.where(act, s, ctx)
        return (x, p + rank[-1], ctx), s.astype(jnp.uint8)

    init = (x0, jnp.uint32(2 * N), jnp.zeros((N,), jnp.uint32))
    _, out = jax.lax.scan(step, init, active)
    return out.T.reshape(-1)


_encode_device = jax.jit(_encode_core, static_argnames=("Kmax", "N", "order"))
_decode_device = jax.jit(_decode_core, static_argnames=("K", "N", "order"))


# ---------------------------------------------------------------------------
# single-stream wrappers producing/consuming the exact rans_np stream format
# ---------------------------------------------------------------------------

def encode(data, order: int = 0) -> bytes:
    data = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data.astype(np.uint8, copy=False)
    n = data.shape[0]
    N = choose_num_lanes(n)
    K = lane_layout(n, N)[0]
    etab, ftab = encode_tables(data, N, order)
    if K == 0:
        st = np.tile(np.array([RANS_L >> 16, 0], "<u2"), N)
        return header(N, order, n, ftab) + st.tobytes()
    out, total = _encode_device(jnp.asarray(data), n, jnp.asarray(etab),
                                Kmax=K, N=N, order=order)
    body = np.asarray(out[:int(total)]).astype("<u2").tobytes()
    return header(N, order, n, ftab) + body


def decode(buf) -> bytes:
    N, order, n, etab, s2s, words = decode_tables(buf)
    K = lane_layout(n, N)[0]
    if K == 0:
        return b""
    # pad the word buffer to a bounded shape set (the decoder never reads
    # past the stream's end)
    words = np.concatenate(
        [words, np.zeros(bucket(words.shape[0]) - words.shape[0], "<u2")])
    out = _decode_device(jnp.asarray(words), n, jnp.asarray(etab),
                         jnp.asarray(s2s), K=K, N=N, order=order)
    return np.asarray(out[:n]).tobytes()
