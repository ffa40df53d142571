"""Codec registry: entropy + transform codecs for section payloads.

Reference parity: src/codec.h:65-122 codec vtable, src/compressor.c:18
comp_compress. The entropy core is our own wide-interleaved rANS
(ops/rans_np.py spec, native host coder, ops/rans_gpu.py device coder)
instead of htscodecs' 4-lane coders; LZMA/BZ2/ZLIB come from the Python
standard library (the reference vendors the same C libraries).

Every compress() returns a self-contained payload; the codec id travels in the
section header (format/sections.py). `uncomp_len` is available at decompress
time from the header.
"""

import bz2 as _bz2
import lzma as _lzma
import zlib as _zlib

import numpy as np

from ..ops import rans_np, pack as packops

# codec ids (u8), stable on-disk values
NONE = 0
RANS0 = 1     # wide-interleaved rANS order-0
RANS1 = 2     # order-1
PACK0 = 3     # <=16 distinct symbols: bit-pack, then rANS order-0 on packed
PACK1 = 4     # bit-pack, then rANS order-1 on packed
ZLIB = 5
BZ2 = 6
LZMA = 7
ACGT = 8      # DNA 2-bit pack + exception channel
DELTA_RANS = 9   # byte-wise delta then rANS order-0 (pos-like streams)
RLE0 = 10     # run-length (value,run) pairs, each rANS'd — long-run streams
DOMQ = 11     # dominant-symbol quality: RLE'd dom-mask + rANS'd exceptions
STRIPE4 = 12  # 4-byte-plane transpose then order-1 rANS (u32/f32 arrays)
ARITH0 = 13   # wide-interleaved adaptive range coder, order-0
ARITH1 = 14   # order-1 (context = previous byte)
BWT = 15      # block-sorting (BSC role): vectorized BWT + adaptive coder
ACGT_LZ = 16  # 2-bit pack + LZMA-1 over the packed stream: repeat-family
              # genomes give LZ matches the entropy stage can't see
              # (codec_acgt.c's pack + sub-codec shape, LZ sub-codec)

NAMES = {NONE: "NONE", RANS0: "RANS0", RANS1: "RANS1", PACK0: "PACK0",
         PACK1: "PACK1", ZLIB: "ZLIB", BZ2: "BZ2", LZMA: "LZMA", ACGT: "ACGT",
         DELTA_RANS: "DELTA", RLE0: "RLE0", DOMQ: "DOMQ", STRIPE4: "STRIPE4",
         ARITH0: "ARITH0", ARITH1: "ARITH1", BWT: "BWT", ACGT_LZ: "ACGTLZ"}

# codecs whose entropy stage is one W32x16 rANS stream (rans_stage); streams
# of at least DEVICE_MIN symbols go through the batched device coder when
# one is present, smaller ones stay on the host coder
RANS_STAGED = (RANS0, RANS1, PACK0, PACK1, ACGT)
DEVICE_MIN = 256 * 1024


def device_coder():
    """The batched device rANS coder (ops/rans_gpu: encode_many,
    decode_many), or None. On exactly when JAX's default backend is a GPU.
    Its streams are byte-identical to the host coder's, so archives do not
    depend on whether it ran."""
    import jax
    if jax.default_backend() != "gpu":
        return None
    from ..ops import rans_gpu
    return rans_gpu


def _rans_encode(data: bytes, order: int) -> bytes:
    from .. import native
    if native.available():
        return native.rans_encode(data, order)
    return rans_np.encode(data, order=order)


def _rans_decode(blob) -> bytes:
    from .. import native
    if native.available():
        return native.rans_decode(blob)
    return rans_np.decode(blob)


def _arith_encode(data: bytes, order: int) -> bytes:
    from .. import native
    if native.available():
        return native.arith_encode(data, order)
    from ..ops import arith_np
    return arith_np.encode(data, order=order)


def _arith_decode(blob) -> bytes:
    from .. import native
    if native.available():
        return native.arith_decode(blob)
    from ..ops import arith_np
    return arith_np.decode(blob)


def _byte_hist(a: np.ndarray) -> np.ndarray:
    from .. import native
    if native.available():
        return native.byte_hist(a)
    return np.bincount(a, minlength=256)


def _pack_stage(data: bytes, order: int):
    from .. import native
    a = np.frombuffer(data, np.uint8)
    syms = np.nonzero(_byte_hist(a))[0].astype(np.uint8)
    ns = syms.shape[0]
    if ns <= 2:
        width = 1
    elif ns <= 4:
        width = 2
    elif ns <= 16:
        width = 4
    else:
        raise ValueError("PACK needs <=16 distinct symbols")
    lut = np.zeros(256, np.uint8)
    lut[syms] = np.arange(ns, dtype=np.uint8)
    if native.available():
        packed = native.pack_lut(a, lut, width)
    else:
        packed = packops.pack_np(lut[a], width)
    head = bytes([ns, width]) + len(a).to_bytes(8, "little") + syms.tobytes()
    return packed.tobytes(), order, lambda sub: head + sub


def _pack_substream(blob):
    from .. import native
    blob = memoryview(blob)
    ns, width = blob[0], blob[1]
    n = int.from_bytes(blob[2:10], "little")
    syms = np.frombuffer(blob[10:10 + ns], np.uint8)

    def finish(packed):
        packed = np.frombuffer(packed, np.uint8)
        if native.available():
            return native.unpack_lut(packed, n, width, syms).tobytes()
        return syms[packops.unpack_np(packed, width, n)].tobytes()
    return blob[10 + ns:], finish


def _acgt_stage(data: bytes):
    a = np.frombuffer(data, np.uint8)
    from .. import native
    if native.available():
        packed, exc_pos, exc_bytes = native.acgt_pack(a)
    else:
        packed, exc_pos, exc_bytes = packops.seq_pack_2bit(a)
    e_pos = _rans_encode(np.diff(exc_pos, prepend=np.uint32(0)).astype("<u4").tobytes(), 0)
    e_b = _rans_encode(exc_bytes.tobytes(), 0)

    def finish(p):
        head = len(a).to_bytes(8, "little") + \
            len(exc_pos).to_bytes(8, "little") + \
            len(p).to_bytes(8, "little") + len(e_pos).to_bytes(8, "little")
        return head + p + e_pos + e_b
    return packed.tobytes(), 0, finish


def _acgt_substream(blob):
    blob = memoryview(blob)
    n = int.from_bytes(blob[0:8], "little")
    ne = int.from_bytes(blob[8:16], "little")
    lp = int.from_bytes(blob[16:24], "little")
    lep = int.from_bytes(blob[24:32], "little")
    off = 32 + lp

    def finish(packed):
        packed = np.frombuffer(packed, np.uint8)
        exc_pos = np.cumsum(np.frombuffer(
            _rans_decode(blob[off:off + lep]), "<u4")[:ne].astype(np.int64))
        exc_bytes = np.frombuffer(_rans_decode(blob[off + lep:]),
                                  np.uint8)[:ne]
        assert exc_pos.shape[0] == ne
        from .. import native
        if native.available():
            return native.acgt_unpack(packed, n, exc_pos, exc_bytes).tobytes()
        return packops.seq_unpack_2bit(packed, n, exc_pos,
                                       exc_bytes).tobytes()
    return blob[32:off], finish


def rans_stage(data: bytes, codec: int):
    """The entropy stage of `codec` when it is one W32x16 rANS stream:
    (payload, order, finish), where finish(stream) gives the codec's blob.
    None for codecs without such a stage. The stream may come from any
    coder: host and device streams are byte-identical."""
    if codec in (RANS0, RANS1):
        return data, codec - RANS0, lambda sub: sub
    if codec in (PACK0, PACK1):
        return _pack_stage(data, codec - PACK0)
    if codec == ACGT:
        return _acgt_stage(data)
    return None


def rans_substream(blob, codec: int):
    """Inverse of rans_stage: (stream, finish), where finish(decoded
    stream) gives the payload; None for codecs without such a stage."""
    if codec in (RANS0, RANS1):
        return blob, bytes
    if codec in (PACK0, PACK1):
        return _pack_substream(blob)
    if codec == ACGT:
        return _acgt_substream(blob)
    return None


def _delta_encode(data: bytes) -> bytes:
    a = np.frombuffer(data, np.uint8)
    d = np.diff(a, prepend=np.uint8(0))
    return _rans_encode(d.tobytes(), 0)


def _delta_decode(blob) -> bytes:
    d = np.frombuffer(_rans_decode(blob), np.uint8)
    return np.cumsum(d.astype(np.uint64)).astype(np.uint8).tobytes()


def _rle_encode(data: bytes) -> bytes:
    a = np.frombuffer(data, np.uint8)
    if a.shape[0] == 0:
        return (0).to_bytes(8, "little")
    change = np.concatenate([[True], a[1:] != a[:-1]])
    starts = np.nonzero(change)[0]
    vals = a[starts]
    runs = np.diff(np.concatenate([starts, [a.shape[0]]]))
    # u32 runs, STRIPE'd by byte plane (htscodecs-style) so order-0 rANS sees
    # each byte position's own distribution (hi planes are ~all zero)
    v = _rans_encode(vals.tobytes(), 0)
    rb = np.ascontiguousarray(runs.astype("<u4").view(np.uint8).reshape(-1, 4).T)
    r = _rans_encode(rb.tobytes(), 0)
    return len(vals).to_bytes(8, "little") + len(v).to_bytes(8, "little") + v + r


def _rle_decode(blob) -> bytes:
    blob = memoryview(blob)
    nr = int.from_bytes(blob[0:8], "little")
    if nr == 0:
        return b""
    lv = int.from_bytes(blob[8:16], "little")
    vals = np.frombuffer(_rans_decode(blob[16:16 + lv]), np.uint8)[:nr]
    rb = np.frombuffer(_rans_decode(blob[16 + lv:]), np.uint8)[:4 * nr]
    runs = np.ascontiguousarray(rb.reshape(4, -1).T).view("<u4").reshape(-1).astype(np.int64)
    return np.repeat(vals, runs).tobytes()


def _domq_encode(data: bytes) -> bytes:
    """Dominant-quality codec (reference src/codec_domq.c): one score
    dominates; store the dom-run structure (RLE of the dom mask) plus the
    exception bytes order-1 coded."""
    a = np.frombuffer(data, np.uint8)
    if a.shape[0] == 0:
        return bytes([0]) + (0).to_bytes(8, "little")
    counts = _byte_hist(a)
    dom = int(np.argmax(counts))
    mask = (a == dom).astype(np.uint8)
    exc = a[mask == 0]
    m = _rle_encode(mask.tobytes())
    e = _rans_encode(exc.tobytes(), 1)
    return bytes([dom]) + len(m).to_bytes(8, "little") + m + e


def _domq_decode(blob) -> bytes:
    blob = memoryview(blob)
    dom = blob[0]
    lm = int.from_bytes(blob[1:9], "little")
    if lm == 0 and len(blob) == 9:
        return b""
    mask = np.frombuffer(_rle_decode(blob[9:9 + lm]), np.uint8)
    exc = np.frombuffer(_rans_decode(blob[9 + lm:]), np.uint8)
    out = np.full(mask.shape[0], dom, dtype=np.uint8)
    nex = int((mask == 0).sum())
    out[mask == 0] = exc[:nex]
    return out.tobytes()


def _stripe4_encode(data: bytes) -> bytes:
    """Byte-plane transpose for 4-byte-element arrays (htscodecs STRIPE):
    each byte position of u32/f32 values gets its own run of the stream so
    order-1 rANS models per-plane distributions. Tail bytes (len%4) pass
    through uncoded."""
    n4 = len(data) // 4
    head = data[: n4 * 4]
    tail = data[n4 * 4:]
    a = np.frombuffer(head, np.uint8).reshape(-1, 4)
    planes = np.ascontiguousarray(a.T).tobytes()
    sub = _rans_encode(planes, 1)
    return len(tail).to_bytes(1, "little") + tail + sub


def _stripe4_decode(blob) -> bytes:
    blob = memoryview(blob)
    lt = blob[0]
    tail = bytes(blob[1:1 + lt])
    planes = np.frombuffer(_rans_decode(blob[1 + lt:]), np.uint8)
    n4 = planes.shape[0] // 4
    a = np.ascontiguousarray(planes[:4 * n4].reshape(4, -1).T)
    return a.tobytes() + tail


def compress(data: bytes, codec: int) -> bytes:
    if codec == NONE:
        return bytes(data)
    stage = rans_stage(data, codec)
    if stage is not None:
        sub, order, finish = stage
        return finish(_rans_encode(sub, order))
    if codec == ZLIB:
        from .. import native
        if native.available() and len(data) > 0:
            return native.zlib_compress(data, 6)
        return _zlib.compress(bytes(data), 6)
    if codec == BZ2:
        return _bz2.compress(bytes(data), 9)
    if codec == LZMA:
        return _lzma.compress(bytes(data), preset=6)
    if codec == ACGT_LZ:
        packed, _, finish = _acgt_stage(data)
        return finish(_lzma.compress(packed, preset=1))
    if codec == DELTA_RANS:
        return _delta_encode(data)
    if codec == RLE0:
        return _rle_encode(data)
    if codec == DOMQ:
        return _domq_encode(data)
    if codec == STRIPE4:
        return _stripe4_encode(data)
    if codec == ARITH0:
        return _arith_encode(data, 0)
    if codec == ARITH1:
        return _arith_encode(data, 1)
    if codec == BWT:
        from . import bwt as bwt_mod
        return bwt_mod.compress(bytes(data), ARITH1)
    raise ValueError(f"unknown codec {codec}")


def decompress(blob, codec: int, uncomp_len: int) -> bytes:
    sub = rans_substream(blob, codec)
    if codec == NONE:
        out = bytes(blob)
    elif sub is not None:
        out = sub[1](_rans_decode(sub[0]))
    elif codec == ZLIB:
        from .. import native
        if native.available() and uncomp_len > 0:
            out = native.zlib_decompress(blob, uncomp_len)
        else:
            out = _zlib.decompress(bytes(blob))
    elif codec == BZ2:
        out = _bz2.decompress(bytes(blob))
    elif codec == LZMA:
        out = _lzma.decompress(bytes(blob))
    elif codec == ACGT_LZ:
        stream, finish = _acgt_substream(blob)
        out = finish(_lzma.decompress(bytes(stream)))
    elif codec == DELTA_RANS:
        out = _delta_decode(blob)
    elif codec == RLE0:
        out = _rle_decode(blob)
    elif codec == DOMQ:
        out = _domq_decode(blob)
    elif codec == STRIPE4:
        out = _stripe4_decode(blob)
    elif codec in (ARITH0, ARITH1):
        out = _arith_decode(blob)
    elif codec == BWT:
        from . import bwt as bwt_mod
        out = bwt_mod.decompress(blob)
    else:
        raise ValueError(f"unknown codec {codec}")
    return checked(out, codec, uncomp_len)


def checked(out: bytes, codec: int, uncomp_len: int) -> bytes:
    """A decoded payload cut to its header length and checked."""
    if len(out) > uncomp_len and codec in (RANS0, RANS1, DELTA_RANS):
        out = out[:uncomp_len]  # padded streams of older archives
    assert len(out) == uncomp_len, f"codec {NAMES.get(codec)} length mismatch: {len(out)} != {uncomp_len}"
    return out
