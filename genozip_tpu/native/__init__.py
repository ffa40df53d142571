"""ctypes loader for the native host runtime (gxz_native.cpp).

Builds libgxz.so on first use with g++ -march=native, beside the source. The
build is keyed to the source and to the host CPU (a stamp file records both),
so a library that travelled with the tree from another machine is rebuilt
rather than trusted. Falls back gracefully — callers must check
`available()`; with GXZ_REQUIRE_NATIVE set, a failed build or load raises
with the compiler's message instead.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "gxz_native.cpp")
_LIB = os.path.join(_DIR, "libgxz.so")
_STAMP = _LIB + ".key"

_lock = threading.Lock()
_lib = None
_tried = False


def _build_key() -> str:
    """Source digest + the host CPU's model and feature flags."""
    h = hashlib.sha256(open(_SRC, "rb").read())
    try:
        with open("/proc/cpuinfo") as f:
            h.update("".join(ln for ln in f if ln.startswith(
                ("model name", "flags")))[:8192].encode())
    except OSError:
        pass
    return h.hexdigest()


def _have_libdeflate() -> bool:
    """Whether the compiler finds libdeflate's header on this host."""
    r = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                       input="#include <libdeflate.h>\n", text=True,
                       capture_output=True)
    return r.returncode == 0


def _build(key: str):
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
           "-o", tmp, "-lz"]
    if _have_libdeflate():
        cmd += ["-DGXZ_LIBDEFLATE", "-ldeflate"]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("native build failed: " + " ".join(cmd) + "\n"
                           + r.stderr[-4000:])
    os.replace(tmp, _LIB)
    with open(_STAMP + f".{os.getpid()}", "w") as f:
        f.write(key)
    os.replace(_STAMP + f".{os.getpid()}", _STAMP)


def _stamp() -> str | None:
    try:
        with open(_STAMP) as f:
            return f.read()
    except OSError:
        return None


def get():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GXZ_NO_NATIVE"):   # force the numpy fallbacks
            return None
        try:
            key = _build_key()
            if not os.path.exists(_LIB) or _stamp() != key:
                _build(key)
            lib = ctypes.CDLL(_LIB)
            for fn in (lib.gxz_simd_bits, lib.gxz_has_libdeflate):
                fn.restype = ctypes.c_int
                fn.argtypes = []
            lib.gxz_rans_encode.restype = ctypes.c_int64
            lib.gxz_rans_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64]
            lib.gxz_rans_decode.restype = ctypes.c_int64
            lib.gxz_rans_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64]
            lib.gxz_arith_encode.restype = ctypes.c_int64
            lib.gxz_arith_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int64]
            lib.gxz_arith_decode.restype = ctypes.c_int64
            lib.gxz_arith_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64]
            lib.gxz_bam_scan.restype = ctypes.c_int64
            lib.gxz_bam_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p]
            lib.gxz_adler32.restype = ctypes.c_uint32
            lib.gxz_adler32.argtypes = [ctypes.c_uint32, ctypes.c_void_p,
                                        ctypes.c_int64]
            lib.gxz_bwt_walk.restype = None
            lib.gxz_bwt_walk.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_void_p]
            lib.gxz_xxh64.restype = ctypes.c_uint64
            lib.gxz_xxh64.argtypes = [ctypes.c_uint64, ctypes.c_void_p,
                                      ctypes.c_int64]
            lib.gxz_aes256_ctr.restype = None
            lib.gxz_aes256_ctr.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p, ctypes.c_int64]
            lib.gxz_tokenize.restype = ctypes.c_int64
            lib.gxz_tokenize.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_void_p]
            lib.gxz_acgt_pack.restype = ctypes.c_int64
            lib.gxz_acgt_pack.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p]
            lib.gxz_acgt_unpack.restype = None
            lib.gxz_acgt_unpack.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_int64, ctypes.c_void_p]
            lib.gxz_pbwt_encode.restype = None
            lib.gxz_pbwt_encode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_void_p]
            lib.gxz_pbwt_decode.restype = None
            lib.gxz_pbwt_decode.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_void_p]
            lib.gxz_zlib_compress.restype = ctypes.c_int64
            lib.gxz_zlib_compress.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                              ctypes.c_int32, ctypes.c_void_p,
                                              ctypes.c_int64]
            lib.gxz_zlib_decompress.restype = ctypes.c_int64
            lib.gxz_zlib_decompress.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int64,
                                                ctypes.c_void_p,
                                                ctypes.c_int64]
            lib.gxz_byte_hist.restype = None
            lib.gxz_byte_hist.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                          ctypes.c_void_p]
            lib.gxz_copy_ranges.restype = None
            lib.gxz_copy_ranges.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_int]
            lib.gxz_seq_recon.restype = None
            lib.gxz_seq_recon.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.gxz_renibble.restype = None
            lib.gxz_renibble.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_void_p]
            lib.gxz_int_list_stats.restype = None
            lib.gxz_int_list_stats.argtypes = [ctypes.c_void_p,
                                               ctypes.c_void_p,
                                               ctypes.c_int64, ctypes.c_void_p,
                                               ctypes.c_void_p, ctypes.c_void_p,
                                               ctypes.c_void_p, ctypes.c_void_p]
            lib.gxz_join_cells.restype = None
            lib.gxz_join_cells.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_uint8, ctypes.c_void_p,
                                           ctypes.c_void_p]
            lib.gxz_int_list_parse.restype = None
            lib.gxz_int_list_parse.argtypes = [ctypes.c_void_p,
                                               ctypes.c_void_p,
                                               ctypes.c_int64, ctypes.c_void_p,
                                               ctypes.c_void_p, ctypes.c_void_p,
                                               ctypes.c_void_p]
            lib.gxz_split_fields.restype = None
            lib.gxz_split_fields.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                             ctypes.c_int64, ctypes.c_uint8,
                                             ctypes.c_int, ctypes.c_void_p,
                                             ctypes.c_void_p, ctypes.c_void_p]
            lib.gxz_row_hash.restype = None
            lib.gxz_row_hash.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int64, ctypes.c_void_p]
            lib.gxz_rows_equal_rep.restype = ctypes.c_int
            lib.gxz_rows_equal_rep.argtypes = [ctypes.c_void_p,
                                               ctypes.c_void_p,
                                               ctypes.c_void_p, ctypes.c_int64]
            lib.gxz_stride_boundary.restype = ctypes.c_int64
            lib.gxz_stride_boundary.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int64, ctypes.c_int64]
            lib.gxz_seq_diff.restype = ctypes.c_int64
            lib.gxz_seq_diff.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # seq,off,n
                ctypes.c_void_p, ctypes.c_void_p,                   # by_ref,gpos0
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # letters,oplen,oprow
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # roff,goff,K
                ctypes.c_void_p,                                    # ref_codes
                ctypes.c_void_p, ctypes.c_void_p,                   # match,ins lut
                ctypes.c_void_p, ctypes.c_void_p,                   # base2bit,is_acgt
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # mm_row,pos,base
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]   # cap,nonref,nr_len
            lib.gxz_ref_populate.restype = None
            lib.gxz_ref_populate.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64]
            lib.gxz_reverse_rows.restype = None
            lib.gxz_reverse_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p]
            lib.gxz_atoi.restype = None
            lib.gxz_atoi.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.gxz_itoa.restype = ctypes.c_int64
            lib.gxz_itoa.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p]
            lib.gxz_nib_expand.restype = ctypes.c_int64
            lib.gxz_nib_expand.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            lib.gxz_count_eq.restype = None
            lib.gxz_count_eq.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_uint8, ctypes.c_void_p]
            lib.gxz_pack_lut.restype = None
            lib.gxz_pack_lut.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p]
            lib.gxz_unpack_lut.restype = None
            lib.gxz_unpack_lut.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.gxz_bgzf_scan.restype = ctypes.c_int64
            lib.gxz_bgzf_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.gxz_bgzf_inflate.restype = ctypes.c_int64
            lib.gxz_bgzf_inflate.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            lib.gxz_bgzf_deflate.restype = ctypes.c_int64
            lib.gxz_bgzf_deflate.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int64]
            lib.gxz_bgzf_deflate_exact.restype = ctypes.c_int64
            lib.gxz_bgzf_deflate_exact.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int]
            lib.gxz_raw_deflate.restype = ctypes.c_int64
            lib.gxz_raw_deflate.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_int64]
            _lib = lib
        except Exception as e:
            if os.environ.get("GXZ_REQUIRE_NATIVE"):
                raise RuntimeError(
                    "native runtime failed to build/load "
                    f"(GXZ_REQUIRE_NATIVE is set): {e}") from e
            _lib = None
    return _lib


def available() -> bool:
    return get() is not None


def simd_bits() -> int:
    """Vector width of the compiled rANS cores: 512 (AVX-512) or 0."""
    return get().gxz_simd_bits()


def has_libdeflate() -> bool:
    """False when the build uses zlib in libdeflate's place."""
    return bool(get().gxz_has_libdeflate())


def zlib_compress(data, level: int = 6) -> bytes:
    """zlib-format compress via libdeflate (~2-3x stdlib zlib), or zlib."""
    lib = get()
    a = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    n = a.shape[0]
    cap = n + n // 16 + 1024
    out = np.empty(cap, np.uint8)
    r = lib.gxz_zlib_compress(a.ctypes.data if n else 0, n, level,
                              out.ctypes.data, cap)
    assert r > 0, "native zlib compress failed"
    return out[:r].tobytes()


def zlib_decompress(blob, out_len: int) -> bytes:
    lib = get()
    a = np.frombuffer(blob, np.uint8) if not isinstance(blob, np.ndarray) \
        else blob
    out = np.empty(max(out_len, 1), np.uint8)
    r = lib.gxz_zlib_decompress(a.ctypes.data, a.shape[0], out.ctypes.data,
                                out_len)
    assert r == out_len, f"native zlib decompress failed ({r})"
    return out[:out_len].tobytes()


def byte_hist(a: np.ndarray) -> np.ndarray:
    """256-bin histogram of a uint8 array (np.bincount without the
    intp-promotion temp that makes it ~10-50x slower on large arrays)."""
    lib = get()
    a = np.ascontiguousarray(a, np.uint8)
    out = np.empty(256, np.int64)
    lib.gxz_byte_hist(a.ctypes.data, a.shape[0], out.ctypes.data)
    return out


def rans_encode(data: bytes, order: int = 0) -> bytes:
    lib = get()
    a = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    n = a.shape[0]
    cap = 2 * n + (1 << 20)  # word buffer is 2*(n + 2N + 8) bytes + header
    out = np.empty(cap, np.uint8)
    r = lib.gxz_rans_encode(a.ctypes.data, n, order, out.ctypes.data, cap)
    assert r > 0, "native rans encode failed"
    return out[:r].tobytes()


def rans_decode(blob, n_hint: int | None = None) -> bytes:
    lib = get()
    a = np.frombuffer(blob, np.uint8) if not isinstance(blob, np.ndarray) else blob
    n = int.from_bytes(bytes(a[2:6]), "little")
    out = np.empty(max(n, 1), np.uint8)
    r = lib.gxz_rans_decode(a.ctypes.data, a.shape[0], out.ctypes.data, n)
    assert r == n, f"native rans decode failed ({r})"
    return out[:n].tobytes()


def perm_walk(lf: np.ndarray, li: np.ndarray, prim: int, n: int) -> np.ndarray:
    """Inverse-BWT LF chase (codecs/bwt.py)."""
    lib = get()
    lf = np.ascontiguousarray(lf, np.int64)
    li = np.ascontiguousarray(li, np.int64)
    out = np.empty(n, np.uint8)
    lib.gxz_bwt_walk(lf.ctypes.data, li.ctypes.data, prim, n,
                     out.ctypes.data)
    return out


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of a bytes-like/ndarray (reference digest.c XXH3 role)."""
    lib = get()
    a = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data.view(np.uint8).reshape(-1)
    return int(lib.gxz_xxh64(seed, a.ctypes.data, a.shape[0]))


def arith_encode(data: bytes, order: int = 0) -> bytes:
    lib = get()
    a = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    n = a.shape[0]
    cap = 2 * n + (1 << 20)
    out = np.empty(cap, np.uint8)
    r = lib.gxz_arith_encode(a.ctypes.data, n, order, out.ctypes.data, cap)
    assert r > 0, "native arith encode failed"
    return out[:r].tobytes()


def arith_decode(blob) -> bytes:
    lib = get()
    a = np.frombuffer(blob, np.uint8) if not isinstance(blob, np.ndarray) else blob
    n = int.from_bytes(bytes(a[2:6]), "little")
    out = np.empty(max(n, 1), np.uint8)
    r = lib.gxz_arith_decode(a.ctypes.data, a.shape[0], out.ctypes.data, n)
    assert r == n, f"native arith decode failed ({r})"
    return out[:n].tobytes()


def aes256_ctr(key: bytes, counter0: bytes, data) -> bytes:
    """XOR data with the AES-256-CTR keystream (encrypt == decrypt)."""
    lib = get()
    assert len(key) == 32 and len(counter0) == 16
    buf = np.frombuffer(bytes(data), np.uint8).copy()
    k = np.frombuffer(key, np.uint8)
    c0 = np.frombuffer(counter0, np.uint8)
    lib.gxz_aes256_ctr(k.ctypes.data, c0.ctypes.data, buf.ctypes.data,
                       buf.shape[0])
    return buf.tobytes()


def tokenize(data: np.ndarray, offsets: np.ndarray, max_tokens: int):
    """One-pass tokenizer scan. Returns (tmpl_data, tmpl_lens, values,
    tok_idx, widths) matching seg.py's keep rules (widths = digit-run
    length per kept token, for zero-padded re-rendering)."""
    lib = get()
    n = offsets.shape[0] - 1
    dl = data.shape[0]
    tmpl = np.empty(dl + 1, np.uint8)
    tmpl_lens = np.empty(max(n, 1), np.int64)
    cap = dl // 1 + 1
    values = np.empty(cap, np.int64)
    tok_idx = np.empty(cap, np.int32)
    widths = np.empty(cap, np.uint8)
    tmpl_total = ctypes.c_int64(0)
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    data = np.ascontiguousarray(data)
    nv = lib.gxz_tokenize(data.ctypes.data, off.ctypes.data, n, max_tokens,
                          tmpl.ctypes.data, tmpl_lens.ctypes.data,
                          values.ctypes.data, tok_idx.ctypes.data,
                          ctypes.byref(tmpl_total), widths.ctypes.data)
    # views, not copies: the backing buffers live as long as the slices,
    # and copying multi-MB value streams costs real wall time per VB
    return (tmpl[:tmpl_total.value], tmpl_lens[:n],
            values[:nv], tok_idx[:nv], widths[:nv])


def acgt_pack(seq: np.ndarray):
    lib = get()
    n = seq.shape[0]
    packed = np.empty((n + 3) // 4, np.uint8)
    exc_pos = np.empty(n, np.uint32)
    exc_bytes = np.empty(n, np.uint8)
    ne = lib.gxz_acgt_pack(seq.ctypes.data, n, packed.ctypes.data,
                           exc_pos.ctypes.data, exc_bytes.ctypes.data)
    return packed, exc_pos[:ne].copy(), exc_bytes[:ne].copy()


def acgt_unpack(packed: np.ndarray, n: int, exc_pos: np.ndarray,
                exc_bytes: np.ndarray):
    lib = get()
    out = np.empty(max(n, 1), np.uint8)
    ep = np.ascontiguousarray(exc_pos, dtype=np.uint32)
    eb = np.ascontiguousarray(exc_bytes, dtype=np.uint8)
    lib.gxz_acgt_unpack(packed.ctypes.data, n, ep.ctypes.data,
                        eb.ctypes.data, ep.shape[0], out.ctypes.data)
    return out[:n]


def pbwt_encode(A: np.ndarray) -> np.ndarray:
    lib = get()
    A = np.ascontiguousarray(A, dtype=np.uint8)
    n, H = A.shape
    Y = np.empty_like(A)
    lib.gxz_pbwt_encode(A.ctypes.data, n, H, Y.ctypes.data)
    return Y


def pbwt_decode(Y: np.ndarray) -> np.ndarray:
    lib = get()
    Y = np.ascontiguousarray(Y, dtype=np.uint8)
    n, H = Y.shape
    A = np.empty_like(Y)
    lib.gxz_pbwt_decode(Y.ctypes.data, n, H, A.ctypes.data)
    return A


def copy_ranges(src: np.ndarray, src_starts: np.ndarray, dst: np.ndarray,
                dst_starts: np.ndarray, lens: np.ndarray,
                packed: bool = False):
    """packed=True enables the fixed-16-byte fast path for tiny rows —
    safe only when dst rows are written packed ascending (gather), NOT for
    scatter (interleave)."""
    lib = get()
    n = lens.shape[0]
    src_starts = np.ascontiguousarray(src_starts, dtype=np.int64)
    dst_starts = np.ascontiguousarray(dst_starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    lib.gxz_copy_ranges(src.ctypes.data, src_starts.ctypes.data,
                        dst.ctypes.data, dst_starts.ctypes.data,
                        lens.ctypes.data, n, src.shape[0], dst.shape[0],
                        1 if packed else 0)


def seq_recon(out_off, by_ref, gpos0, letters, oplen, oprow, roff, goff,
              ins_before, ref_codes, acgt, match_lut, ins_lut, nonref,
              nr_off) -> np.ndarray:
    """One-pass CIGAR-driven SEQ rebuild (inverse of gxz_seq_diff);
    mismatch patches applied by the caller."""
    lib = get()
    n = out_off.shape[0] - 1
    out_off = np.ascontiguousarray(out_off, np.int64)
    out = np.zeros(max(int(out_off[-1]), 1), np.uint8)
    args = [np.ascontiguousarray(a, t) for a, t in (
        (by_ref, np.uint8), (gpos0, np.int64), (letters, np.uint8),
        (oplen, np.int64), (oprow, np.int64), (roff, np.int64),
        (goff, np.int64), (ins_before, np.int64))]
    ref_codes = np.ascontiguousarray(ref_codes)
    acgt = np.ascontiguousarray(acgt, np.uint8)
    m_lut = np.ascontiguousarray(match_lut, np.uint8)
    i_lut = np.ascontiguousarray(ins_lut, np.uint8)
    nonref = np.ascontiguousarray(nonref, np.uint8)
    nr_off = np.ascontiguousarray(nr_off, np.int64)
    lib.gxz_seq_recon(out.ctypes.data, out_off.ctypes.data, n,
                      args[0].ctypes.data, args[1].ctypes.data,
                      args[2].ctypes.data, args[3].ctypes.data,
                      args[4].ctypes.data, args[5].ctypes.data,
                      args[6].ctypes.data, args[7].ctypes.data,
                      args[2].shape[0], ref_codes.ctypes.data,
                      ref_codes.shape[0], acgt.ctypes.data,
                      m_lut.ctypes.data, i_lut.ctypes.data,
                      nonref.ctypes.data, nr_off.ctypes.data)
    return out


def renibble(data: np.ndarray, offsets: np.ndarray, nib_of: np.ndarray,
             out_off: np.ndarray) -> np.ndarray:
    """ASCII SEQ rows -> BAM 4-bit nibble rows (2-aligned per row)."""
    lib = get()
    n = offsets.shape[0] - 1
    data = np.ascontiguousarray(data)
    offsets = np.ascontiguousarray(offsets, np.int64)
    out_off = np.ascontiguousarray(out_off, np.int64)
    nib_of = np.ascontiguousarray(nib_of, np.uint8)
    out = np.zeros(max(int(out_off[-1]), 1), np.uint8)
    lib.gxz_renibble(data.ctypes.data, offsets.ctypes.data, n,
                     nib_of.ctypes.data, out.ctypes.data, out_off.ctypes.data)
    return out


def int_list_stats(data: np.ndarray, offsets: np.ndarray):
    """Per-row (sum, min1, min2, nvals, ok) of strict comma-int lists
    (VCF AD/PL; tokenizer keep-rules)."""
    lib = get()
    C = offsets.shape[0] - 1
    data = np.ascontiguousarray(data)
    offsets = np.ascontiguousarray(offsets, np.int64)
    sums = np.empty(C, np.int64)
    m1 = np.empty(C, np.int64)
    m2 = np.empty(C, np.int64)
    nv = np.empty(C, np.int32)
    ok = np.empty(C, np.uint8)
    lib.gxz_int_list_stats(data.ctypes.data, offsets.ctypes.data, C,
                           sums.ctypes.data, m1.ctypes.data, m2.ctypes.data,
                           nv.ctypes.data, ok.ctypes.data)
    return sums, m1, m2, nv, ok.astype(bool)


def join_cells(data: np.ndarray, offsets: np.ndarray, nsub: np.ndarray,
               sep: int):
    """Join consecutive ragged subfields into cells with `sep` between
    them; returns (out bytes, cell offsets (C+1,))."""
    lib = get()
    C = nsub.shape[0]
    data = np.ascontiguousarray(data)
    offsets = np.ascontiguousarray(offsets, np.int64)
    nsub32 = np.ascontiguousarray(nsub, np.int32)
    total = int(offsets[-1]) + int(np.maximum(nsub - 1, 0).sum())
    out = np.empty(max(total, 1), np.uint8)
    cell_off = np.empty(C + 1, np.int64)
    lib.gxz_join_cells(data.ctypes.data, offsets.ctypes.data,
                       nsub32.ctypes.data, C, sep, out.ctypes.data,
                       cell_off.ctypes.data)
    return out[:total], cell_off


def int_list_parse(data: np.ndarray, offsets: np.ndarray):
    """Flat values of strict comma-int lists: (vals of OK rows
    consecutively, nvals per row — 0 where not OK, ok mask)."""
    lib = get()
    C = offsets.shape[0] - 1
    data = np.ascontiguousarray(data)
    offsets = np.ascontiguousarray(offsets, np.int64)
    cap = int((data == ord(",")).sum()) + C + 1
    vals = np.empty(cap, np.int64)
    nv = np.empty(C, np.int32)
    ok = np.empty(C, np.uint8)
    total = np.zeros(1, np.int64)
    lib.gxz_int_list_parse(data.ctypes.data, offsets.ctypes.data, C,
                           vals.ctypes.data, nv.ctypes.data, ok.ctypes.data,
                           total.ctypes.data)
    return vals[:int(total[0])], nv.astype(np.int64), ok.astype(bool)


def split_fields(data: np.ndarray, offsets: np.ndarray, sep: int, T: int):
    """One-pass ragged field split: returns (f_start (T,C) i64,
    f_len (T,C) i32, nfields (C,) i32 — T+1 signals overflow)."""
    lib = get()
    C = offsets.shape[0] - 1
    data = np.ascontiguousarray(data)
    offsets = np.ascontiguousarray(offsets, np.int64)
    f_start = np.empty((T, C), np.int64)
    f_len = np.empty((T, C), np.int32)
    nfields = np.empty(C, np.int32)
    lib.gxz_split_fields(data.ctypes.data, offsets.ctypes.data, C, sep, T,
                         f_start.ctypes.data, f_len.ctypes.data,
                         nfields.ctypes.data)
    return f_start, f_len, nfields


def bam_scan(data: np.ndarray, max_records: int):
    """Walk the serial BAM block_size chain -> (record offsets, consumed).
    Has a python fallback: BAM must degrade in speed, never availability."""
    lib = get()
    if lib is None:
        mv = memoryview(np.ascontiguousarray(data)).cast("B")
        length = data.shape[0]
        offs, off = [], 0
        while off + 4 <= length and len(offs) < max_records:
            block_size = int.from_bytes(mv[off:off + 4], "little")
            if off + 4 + block_size > length:
                break
            offs.append(off)
            off += 4 + block_size
        return np.asarray(offs, np.int64), off
    offsets = np.empty(max_records, np.int64)
    consumed = ctypes.c_int64(0)
    cnt = lib.gxz_bam_scan(data.ctypes.data, data.shape[0],
                           offsets.ctypes.data, max_records,
                           ctypes.byref(consumed))
    return offsets[:cnt], int(consumed.value)


def row_hash(data: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    lib = get()
    n = offsets.shape[0] - 1
    out = np.empty(n, np.uint64)
    data = np.ascontiguousarray(data)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lib.gxz_row_hash(data.ctypes.data, offsets.ctypes.data, n,
                     out.ctypes.data)
    return out


def rows_equal_rep(data: np.ndarray, offsets: np.ndarray,
                   rep: np.ndarray) -> bool:
    lib = get()
    n = offsets.shape[0] - 1
    data = np.ascontiguousarray(data)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    rep = np.ascontiguousarray(rep, dtype=np.int64)
    return bool(lib.gxz_rows_equal_rep(data.ctypes.data, offsets.ctypes.data,
                                       rep.ctypes.data, n))


def stride_boundary(data: np.ndarray, stride: int) -> int:
    lib = get()
    data = np.ascontiguousarray(data)
    return int(lib.gxz_stride_boundary(data.ctypes.data, data.shape[0],
                                       stride))


def seq_diff(seq_data, seq_off, by_ref, gpos0, letters, oplen, oprow,
             roff, goff, ref_codes, match_lut, ins_lut, base2bit, is_acgt,
             nonref_cap: int):
    """One-pass CIGAR-driven SEQ-vs-ref diff (see gxz_seq_diff). Returns
    (mm_row i32, mm_pos i32, mm_base u8, nonref u8)."""
    lib = get()
    n = seq_off.shape[0] - 1
    K = letters.shape[0]
    seq_data = np.ascontiguousarray(seq_data)
    seq_off = np.ascontiguousarray(seq_off, dtype=np.int64)
    by_ref8 = np.ascontiguousarray(by_ref, dtype=np.uint8)
    gpos0 = np.ascontiguousarray(gpos0, dtype=np.int64)
    letters = np.ascontiguousarray(letters, dtype=np.uint8)
    oplen = np.ascontiguousarray(oplen, dtype=np.int64)
    oprow = np.ascontiguousarray(oprow, dtype=np.int64)
    roff = np.ascontiguousarray(roff, dtype=np.int64)
    goff = np.ascontiguousarray(goff, dtype=np.int64)
    m_lut = np.ascontiguousarray(match_lut, dtype=np.uint8)
    i_lut = np.ascontiguousarray(ins_lut, dtype=np.uint8)
    b2b = np.ascontiguousarray(base2bit, dtype=np.uint8)
    isa = np.ascontiguousarray(is_acgt, dtype=np.uint8)
    nonref = np.empty(max(nonref_cap, 1), np.uint8)
    nr_len = ctypes.c_int64(0)
    cap = max(4096, seq_data.shape[0] // 16)
    while True:
        mm_row = np.empty(cap, np.int32)
        mm_pos = np.empty(cap, np.int32)
        mm_base = np.empty(cap, np.uint8)
        cnt = lib.gxz_seq_diff(
            seq_data.ctypes.data, seq_off.ctypes.data, n,
            by_ref8.ctypes.data, gpos0.ctypes.data,
            letters.ctypes.data, oplen.ctypes.data, oprow.ctypes.data,
            roff.ctypes.data, goff.ctypes.data, K,
            ref_codes.ctypes.data,
            m_lut.ctypes.data, i_lut.ctypes.data,
            b2b.ctypes.data, isa.ctypes.data,
            mm_row.ctypes.data, mm_pos.ctypes.data, mm_base.ctypes.data,
            cap, nonref.ctypes.data, ctypes.byref(nr_len))
        if cnt <= cap:
            return (mm_row[:cnt], mm_pos[:cnt], mm_base[:cnt],
                    nonref[:nr_len.value])
        cap = int(cnt)


def ref_populate(seq_data, seq_off, rows, starts, base2bit,
                 ref_codes, is_set, blk_set, blk: int):
    """Scatter pure reads into unset genome positions (REF_INTERNAL)."""
    lib = get()
    seq_data = np.ascontiguousarray(seq_data)
    seq_off = np.ascontiguousarray(seq_off, dtype=np.int64)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    b2b = np.ascontiguousarray(base2bit, dtype=np.uint8)
    lib.gxz_ref_populate(seq_data.ctypes.data, seq_off.ctypes.data,
                         rows.ctypes.data, starts.ctypes.data,
                         rows.shape[0], b2b.ctypes.data,
                         ref_codes.ctypes.data, is_set.ctypes.data,
                         blk_set.ctypes.data, blk)


def reverse_rows(data, offsets, rows, comp_lut=None):
    """In-place reverse (+optional complement) of the selected rows."""
    lib = get()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    lut_ptr = 0
    lut = None
    if comp_lut is not None:
        lut = np.ascontiguousarray(comp_lut, dtype=np.uint8)
        lut_ptr = lut.ctypes.data
    lib.gxz_reverse_rows(data.ctypes.data, offsets.ctypes.data,
                         rows.ctypes.data, rows.shape[0], lut_ptr)


def atoi(data, offsets):
    """Strict per-row decimal parse -> (int64 vals, bool ok)."""
    lib = get()
    n = offsets.shape[0] - 1
    data = np.ascontiguousarray(data)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    vals = np.empty(n, np.int64)
    ok = np.empty(n, np.uint8)
    lib.gxz_atoi(data.ctypes.data, offsets.ctypes.data, n,
                 vals.ctypes.data, ok.ctypes.data)
    return vals, ok.view(bool)


def nib_expand(nib_data, offsets, lseq):
    """BAM 4-bit SEQ -> (ascii data, ascii offsets, per-row nibble-ok)."""
    lib = get()
    n = offsets.shape[0] - 1
    nib_data = np.ascontiguousarray(nib_data)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lseq = np.ascontiguousarray(lseq, dtype=np.int64)
    out_off = np.concatenate([[0], np.cumsum(lseq)])
    out = np.empty(max(int(out_off[-1]), 1), np.uint8)
    ok = np.empty(n, np.uint8)
    lib.gxz_nib_expand(nib_data.ctypes.data, offsets.ctypes.data,
                       lseq.ctypes.data, n, out.ctypes.data, ok.ctypes.data)
    return out[: out_off[-1]], out_off, ok.view(bool)


def bgzf_scan(buf: np.ndarray):
    """Scan whole BGZF blocks -> (offsets i64, bsizes i32, isizes i32,
    consumed, uniform_headers)."""
    lib = get()
    max_blocks = buf.shape[0] // 28 + 2
    boff = np.empty(max_blocks, np.int64)
    bsize = np.empty(max_blocks, np.int32)
    isize = np.empty(max_blocks, np.int32)
    consumed = ctypes.c_int64(0)
    uniform = ctypes.c_int32(1)
    n = lib.gxz_bgzf_scan(buf.ctypes.data, buf.shape[0], max_blocks,
                          boff.ctypes.data, bsize.ctypes.data,
                          isize.ctypes.data, ctypes.byref(consumed),
                          ctypes.byref(uniform))
    return (boff[:n], bsize[:n], isize[:n], int(consumed.value),
            bool(uniform.value))


def bgzf_inflate(buf: np.ndarray, boff, bsize, isize) -> np.ndarray:
    lib = get()
    total = int(isize.sum())
    out = np.empty(max(total, 1), np.uint8)
    boff = np.ascontiguousarray(boff, np.int64)
    bsize = np.ascontiguousarray(bsize, np.int32)
    isize = np.ascontiguousarray(isize, np.int32)
    r = lib.gxz_bgzf_inflate(buf.ctypes.data, boff.ctypes.data,
                             bsize.ctypes.data, isize.ctypes.data,
                             boff.shape[0], out.ctypes.data)
    assert r == total, f"BGZF inflate failed at block {-r - 1}"
    return out[:total]


def bgzf_deflate(data, block: int = 65280, level: int = 6) -> bytes:
    """Deflate into a standard BGZF chain (no EOF marker)."""
    lib = get()
    a = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    n = a.shape[0]
    nblk = n // block + 2
    cap = n + n // 64 + 64 * nblk + 1024
    out = np.empty(cap, np.uint8)
    r = lib.gxz_bgzf_deflate(a.ctypes.data, n, block, level,
                             out.ctypes.data, cap)
    assert r > 0 or n == 0, f"BGZF deflate failed ({r})"
    return out[:max(r, 0)].tobytes()


def raw_deflate(data, level: int) -> bytes:
    """Raw-deflate one payload with libdeflate (level discovery trials)."""
    lib = get()
    a = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    n = a.shape[0]
    cap = n + n // 16 + 1024
    out = np.empty(cap, np.uint8)
    r = lib.gxz_raw_deflate(a.ctypes.data, n, level, out.ctypes.data, cap)
    assert r > 0, "raw deflate failed"
    return out[:r].tobytes()


def bgzf_deflate_exact(data, isizes: np.ndarray, level: int,
                       header: bytes, nthreads: int = 0,
                       lib_kind: str = "zlib") -> bytes:
    """Byte-exact BGZF re-emission: zlib or libdeflate at the discovered
    level, recorded per-block isizes, original 12-byte header template.
    Threaded (reference --bgzf=exact, mgzip.c library matrix)."""
    import os as _os
    lib = get()
    a = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    isz = np.ascontiguousarray(isizes, np.uint32)
    hdr = np.frombuffer(header, np.uint8)
    n = a.shape[0]
    cap = n + n // 32 + (len(header) + 64) * (isz.shape[0] + 1) + 1024
    out = np.empty(cap, np.uint8)
    if not nthreads:
        nthreads = max(_os.cpu_count() or 1, 1)
    r = lib.gxz_bgzf_deflate_exact(
        a.ctypes.data, n, isz.ctypes.data, isz.shape[0], level,
        hdr.ctypes.data, hdr.shape[0], nthreads, out.ctypes.data, cap,
        1 if lib_kind == "libdeflate" else 0)
    assert r >= 0, f"exact BGZF deflate failed ({r})"
    return out[:r].tobytes()


def pack_lut(data: np.ndarray, lut: np.ndarray, width: int) -> np.ndarray:
    """codes = lut[data] packed `width` bits each (one pass)."""
    lib = get()
    n = data.shape[0]
    per = 8 // width
    out = np.empty((n + per - 1) // per, np.uint8)
    data = np.ascontiguousarray(data)
    lut = np.ascontiguousarray(lut, np.uint8)
    lib.gxz_pack_lut(data.ctypes.data, n, lut.ctypes.data, width,
                     out.ctypes.data)
    return out


def unpack_lut(packed: np.ndarray, n: int, width: int,
               syms: np.ndarray) -> np.ndarray:
    """out[i] = syms[packed code i] (one pass)."""
    lib = get()
    out = np.empty(max(n, 1), np.uint8)
    packed = np.ascontiguousarray(packed)
    syms = np.ascontiguousarray(syms, np.uint8)
    # syms LUT is indexed by full code width; pad to the code range
    full = np.zeros(16 if width == 4 else (4 if width == 2 else 2), np.uint8)
    full[:syms.shape[0]] = syms
    lib.gxz_unpack_lut(packed.ctypes.data, n, width, full.ctypes.data,
                       out.ctypes.data)
    return out[:n]


def count_eq(data, offsets, sep: int):
    """Per-row count of bytes == sep."""
    lib = get()
    n = offsets.shape[0] - 1
    data = np.ascontiguousarray(data)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.empty(max(n, 1), np.int64)
    lib.gxz_count_eq(data.ctypes.data, offsets.ctypes.data, n, sep,
                     out.ctypes.data)
    return out[:n]


def itoa(vals):
    """int64 rows -> (ascii data, offsets)."""
    lib = get()
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    n = vals.shape[0]
    offsets = np.empty(n + 1, np.int64)
    total = lib.gxz_itoa(vals.ctypes.data, n, offsets.ctypes.data, 0)
    out = np.empty(max(int(total), 1), np.uint8)
    lib.gxz_itoa(vals.ctypes.data, n, offsets.ctypes.data, out.ctypes.data)
    return out[:total], offsets
