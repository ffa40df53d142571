"""BGZF block-gzip writer (reference parity: src/mgzip.c BGZF re-compression
on PIZ output; the isize-exact re-emission mode is a later milestone — this
emits standard 64KB BGZF blocks + EOF marker, htslib-compatible)."""

import struct
import zlib

BLOCK = 65280  # uncompressed payload per BGZF block (htslib convention)

EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _one_block(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 25 + 1
    hdr = struct.pack(
        "<BBBBIBBHBBHH",
        0x1F, 0x8B, 8, 4,       # magic, deflate, FEXTRA
        0, 0, 0xFF,             # mtime, xfl, os
        6,                      # xlen
        0x42, 0x43, 2,          # 'B','C', slen
        bsize - 1)
    return hdr + comp + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                                    len(payload))


class BgzfWriter:
    def __init__(self, fileobj, level: int = 6):
        self.f = fileobj
        self.level = level
        self.buf = bytearray()

    def write(self, data: bytes):
        self.buf += data
        nfull = len(self.buf) // BLOCK
        if not nfull:
            return
        from .. import native
        if native.available():
            # whole-chain deflate in one native call (libdeflate)
            take = nfull * BLOCK
            self.f.write(native.bgzf_deflate(bytes(self.buf[:take]),
                                             BLOCK, self.level))
            del self.buf[:take]
            return
        while len(self.buf) >= BLOCK:
            self.f.write(_one_block(bytes(self.buf[:BLOCK]), self.level))
            del self.buf[:BLOCK]

    def close(self):
        if self.buf:
            from .. import native
            if native.available():
                # same library as the full blocks (keeps the whole file
                # uniformly libdeflate -> exact re-emission discoverable)
                self.f.write(native.bgzf_deflate(bytes(self.buf), BLOCK,
                                                 self.level))
            else:
                self.f.write(_one_block(bytes(self.buf), self.level))
            self.buf.clear()
        self.f.write(EOF_BLOCK)
        self.f.close()


def open_bgzf(path: str, level: int = 6) -> BgzfWriter:
    return BgzfWriter(open(path, "wb"), level)


def is_bgzf(head: bytes) -> bool:
    return (len(head) >= 18 and head[0] == 0x1F and head[1] == 0x8B
            and head[3] & 4 and head[12] == 0x42 and head[13] == 0x43)


class BgzfBlockReader:
    """Block-aware BGZF reader recording per-block isizes + the info needed
    for byte-exact re-emission (reference src/mgzip.c: SEC_GZ_ISIZES +
    FlagsMgzip library/level discovery)."""

    def __init__(self, fileobj):
        self.f = fileobj
        self.isizes = []
        self.header_template = None   # first block's 12-byte fixed header
        self.exact_level = None       # discovered zlib level, or None
        self.uniform_headers = True
        self._probe = None            # (payload, deflate_bytes) of 1st block
        self._raw = b""               # compressed tail awaiting a full block

    def read(self, want: int) -> bytes:
        from .. import native
        if native.available():
            return self._read_native(want)
        out = bytearray()
        while len(out) < want:
            hdr = self.f.read(18)
            if not hdr:
                break
            assert is_bgzf(hdr), "BGZF stream corrupt"
            if self.header_template is None:
                self.header_template = hdr[:12]
            elif hdr[:12] != self.header_template:
                self.uniform_headers = False
            bsize = int.from_bytes(hdr[16:18], "little") + 1
            rest = self.f.read(bsize - 18)
            comp = rest[: bsize - 18 - 8]
            isize = int.from_bytes(rest[-4:], "little")
            payload = zlib.decompress(comp, -15) if comp else b""
            assert len(payload) == isize, "BGZF isize mismatch"
            self.isizes.append(isize)
            if self._probe is None and isize > 0:
                self._probe = (payload, comp)
            out += payload
        return bytes(out)

    def _read_native(self, want: int) -> bytes:
        """Batch scan + inflate a run of blocks in one native call
        (reference src/mgzip.c whole-block reads, zip.c:520-521). Returns at
        most `want` bytes (file.read contract); surplus plaintext from the
        inflated batch is kept for the next call."""
        from .. import native
        import numpy as np
        parts = []
        got = 0
        if getattr(self, "_plain", b""):
            take = self._plain[:want]
            self._plain = self._plain[want:]
            parts.append(take)
            got += len(take)
        while got < want:
            # compressed is smaller than plaintext, so `want - got`
            # compressed bytes always cover the remaining need
            chunk = self.f.read(max(want - got, 1 << 20))
            if chunk:
                self._raw = self._raw + chunk if self._raw else chunk
            if not self._raw:
                break
            buf = np.frombuffer(self._raw, np.uint8)
            boff, bsize, isize, consumed, uniform = native.bgzf_scan(buf)
            if consumed == 0:
                if chunk:
                    continue        # partial block: need more bytes
                raise AssertionError("BGZF stream corrupt")
            first_hdr = bytes(buf[int(boff[0]):int(boff[0]) + 12])
            if self.header_template is None:
                self.header_template = first_hdr
            if not uniform or first_hdr != self.header_template:
                self.uniform_headers = False
            payload = native.bgzf_inflate(buf, boff, bsize, isize)
            self.isizes.extend(int(x) for x in isize)
            if self._probe is None:
                nz = np.nonzero(isize > 0)[0]
                if nz.shape[0]:
                    i = int(nz[0])
                    o0 = int(isize[:i].sum())
                    comp = bytes(buf[int(boff[i]) + 18:
                                     int(boff[i] + bsize[i]) - 8])
                    self._probe = (payload[o0:o0 + int(isize[i])].tobytes(),
                                   comp)
            pb = payload.tobytes()
            need = want - got
            if len(pb) > need:
                self._plain = pb[need:]
                pb = pb[:need]
            parts.append(pb)
            got += len(pb)
            self._raw = self._raw[consumed:]
            if not chunk and not self._raw:
                break
        if not parts:
            return b""
        return b"".join(bytes(p) for p in parts) if len(parts) > 1 \
            else bytes(parts[0])

    def discover_level(self):
        """Trial zlib levels 1..9, then libdeflate 1..12, against the first
        block (reference txtfile_discover_specific_gz + the mgzip.c writer-
        library matrix).  Returns (lib, level) or None."""
        if self._probe is None:
            return None
        payload, comp = self._probe
        for lvl in range(1, 10):
            co = zlib.compressobj(lvl, zlib.DEFLATED, -15)
            if co.compress(payload) + co.flush() == comp:
                self.exact_level = ("zlib", lvl)
                return self.exact_level
        from .. import native
        if native.available() and native.has_libdeflate():
            for lvl in range(1, 13):
                if native.raw_deflate(payload, lvl) == comp:
                    self.exact_level = ("libdeflate", lvl)
                    return self.exact_level
        return None

    def mgzip_info(self):
        disc = self.discover_level()
        if disc is None or not self.uniform_headers or \
                self.header_template is None or \
                self.header_template[10:12] != b"\x06\x00":  # XLEN == 6 (BC only)
            return {"kind": "bgzf", "exact": False}
        lib, lvl = disc
        return {"kind": "bgzf", "exact": True, "level": lvl, "lib": lib,
                "header": self.header_template.hex()}

    def close(self):
        self.f.close()


class ExactBgzfWriter:
    """Re-emit a BGZF file byte-exactly from recorded isizes + level +
    header template (only when discover_level matched)."""

    def __init__(self, fileobj, isizes, level: int, header: bytes,
                 lib: str = "zlib"):
        self.f = fileobj
        self.isizes = list(isizes)
        self.level = level
        self.header = header
        self.lib = lib
        self.buf = bytearray()
        self.block_i = 0

    def _emit(self, payload: bytes):
        if not payload:
            # empty block (EOF marker): canonical 2-byte zlib-style final
            # block, constant across writer libraries (htslib bgzf.c)
            comp = b"\x03\x00"
        elif self.lib == "libdeflate":
            from .. import native
            comp = native.raw_deflate(payload, self.level)
        else:
            co = zlib.compressobj(self.level, zlib.DEFLATED, -15)
            comp = co.compress(payload) + co.flush()
        # template = 12 fixed bytes (magic..XLEN); BC subfield + BSIZE follow
        bsize = len(comp) + len(self.header) + 6 + 8
        self.f.write(self.header)
        self.f.write(struct.pack("<BBHH", 0x42, 0x43, 2, bsize - 1))
        self.f.write(comp)
        self.f.write(struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                                 len(payload)))

    def write(self, data: bytes):
        self.buf += data
        from .. import native
        if native.available():
            # batch all fully-covered blocks into one threaded native call
            import numpy as np
            isz = self.isizes
            b0 = self.block_i
            acc = 0
            b1 = b0
            while b1 < len(isz) and acc + isz[b1] <= len(self.buf):
                acc += isz[b1]
                b1 += 1
            if b1 > b0:
                blob = native.bgzf_deflate_exact(
                    bytes(self.buf[:acc]), np.asarray(isz[b0:b1], np.uint32),
                    self.level, self.header, lib_kind=self.lib)
                self.f.write(blob)
                del self.buf[:acc]
                self.block_i = b1
            return
        while self.block_i < len(self.isizes):
            need = self.isizes[self.block_i]
            if need == 0:
                break  # zero blocks handled at close
            if len(self.buf) < need:
                break
            self._emit(bytes(self.buf[:need]))
            del self.buf[:need]
            self.block_i += 1

    def close(self):
        from .. import native
        if native.available() and self.block_i < len(self.isizes):
            import numpy as np
            isz = np.asarray(self.isizes[self.block_i:], np.uint32)
            need = int(isz.sum())
            assert len(self.buf) == need, "BGZF-exact: plaintext/isize mismatch"
            blob = native.bgzf_deflate_exact(bytes(self.buf), isz,
                                             self.level, self.header,
                                             lib_kind=self.lib)
            self.f.write(blob)
            self.buf.clear()
            self.block_i = len(self.isizes)
            self.f.close()
            return
        while self.block_i < len(self.isizes):
            need = self.isizes[self.block_i]
            if need == 0:
                self._emit(b"")
            else:
                assert len(self.buf) >= need, "BGZF-exact: short plaintext"
                self._emit(bytes(self.buf[:need]))
                del self.buf[:need]
            self.block_i += 1
        assert not self.buf, "BGZF-exact: plaintext longer than recorded"
        self.f.close()


# ---------------------------------------------------------------------------
# Generic multi-member gz dialects (reference src/mgzip.h:14-33 matrix:
# IL1M/IL4M/MGZF/MGSP/EMFL/EMVL/GZBL — BGZF has its own reader above).
# One member-splitting reader handles them all: gzip members are found with
# zlib's member-end detection, per-member headers + isizes recorded, the
# dialect classified from header + isize pattern, and — when the deflate
# level is discovered and headers are uniform — PIZ re-emits the original
# bytes exactly (the reference's --bgzf=exact generalized to the family).
# ---------------------------------------------------------------------------

def _gz_header_len(buf: bytes) -> int:
    """Length of one gzip member header (enough of buf must be present)."""
    assert buf[:2] == b"\x1f\x8b" and buf[2] == 8, "not a gzip member"
    flg = buf[3]
    off = 10
    if flg & 4:                            # FEXTRA
        xlen = int.from_bytes(buf[off:off + 2], "little")
        off += 2 + xlen
    if flg & 8:                            # FNAME
        off = buf.index(b"\x00", off) + 1
    if flg & 16:                           # FCOMMENT
        off = buf.index(b"\x00", off) + 1
    if flg & 2:                            # FHCRC
        off += 2
    return off


def classify_mgzip(header: bytes, isizes) -> str:
    """Dialect name from the first member header + isize pattern
    (mgzip.h:14-33)."""
    body = [i for i in isizes[:-1] if i > 0] if len(isizes) > 1 else isizes
    if len(header) >= 16 and header[3] & 4 and header[12:14] == b"IG":
        return "mgzf"                       # MGI 32-bit BGZF variant
    if body and all(i == (1 << 20) for i in body):
        return "il1m"                       # Illumina 1MB members
    if body and all(i == (4 << 20) for i in body):
        return "il4m"
    if header[8:10] == b"\x00\x03" and len(set(body)) <= 1:
        return "mgsp"                       # MGI same-isize groups
    if isizes and isizes[0] == 0:
        return "emvl"                       # Element: leading empty block
    if body and len(set(body)) == 1:
        return "emfl"                       # Element fixed-length
    return "gzbl"                           # generic gz blocks


class MgzipBlockReader:
    """Member-splitting reader for the non-BGZF multi-member gz dialects.
    Records per-member isizes + headers for dialect classification and
    byte-exact re-emission."""

    def __init__(self, fileobj):
        self.f = fileobj
        self.isizes = []
        self.headers_uniform = True
        self.header0 = None
        self._probe = None                  # (payload, deflate bytes)
        self._raw = b""                     # unparsed input bytes
        self._eof_in = False
        self._out = bytearray()

    def _fill(self, n=1 << 20):
        if not self._eof_in:
            chunk = self.f.read(n)
            if not chunk:
                self._eof_in = True
            self._raw += chunk

    def _read_member(self) -> bool:
        while len(self._raw) < 10 and not self._eof_in:
            self._fill()
        if not self._raw:
            return False
        while True:
            try:
                hl = _gz_header_len(self._raw)
                break
            except (IndexError, ValueError):
                if self._eof_in:
                    raise AssertionError("truncated gz member header")
                self._fill()
        hdr = self._raw[:hl]
        if self.header0 is None:
            self.header0 = hdr
        elif hdr != self.header0:
            self.headers_uniform = False
        d = zlib.decompressobj(-15)
        pos = hl
        payload = bytearray()
        comp_parts = []
        while True:
            if pos >= len(self._raw):
                if self._eof_in:
                    raise AssertionError("truncated gz member")
                self._fill()
            chunk = self._raw[pos:]
            out = d.decompress(chunk)
            payload += out
            if d.eof:
                used = len(chunk) - len(d.unused_data)
                comp_parts.append(chunk[:used])
                pos += used
                break
            comp_parts.append(chunk)
            pos += len(chunk)
        # trailer: crc32 + isize
        while len(self._raw) < pos + 8 and not self._eof_in:
            self._fill()
        isize = int.from_bytes(self._raw[pos + 4:pos + 8], "little")
        assert (len(payload) & 0xFFFFFFFF) == isize, "gz isize mismatch"
        self._raw = self._raw[pos + 8:]
        self.isizes.append(len(payload))
        if self._probe is None and payload:
            self._probe = (bytes(payload), b"".join(comp_parts))
        self._out += payload
        return True

    def read(self, want: int) -> bytes:
        while len(self._out) < want:
            if not self._read_member():
                break
        out = bytes(self._out[:want])
        del self._out[:want]
        return out

    def discover_level(self):
        if self._probe is None:
            return None
        payload, comp = self._probe
        for lvl in range(1, 10):
            co = zlib.compressobj(lvl, zlib.DEFLATED, -15)
            if co.compress(payload) + co.flush() == comp:
                return lvl
        return None

    def mgzip_info(self):
        # drain remaining members so the isize list is complete
        while self._read_member():
            pass
        kind = classify_mgzip(self.header0 or b"", self.isizes)
        lvl = self.discover_level()
        if lvl is None or not self.headers_uniform or self.header0 is None:
            return {"kind": kind, "exact": False}
        return {"kind": kind, "exact": True, "level": lvl,
                "header": self.header0.hex()}

    def close(self):
        self.f.close()


class MgzipExactWriter:
    """Byte-exact re-emission of a multi-member gz file from recorded
    isizes + uniform header + discovered level (any non-BGZF dialect)."""

    def __init__(self, fileobj, isizes, level: int, header: bytes):
        self.f = fileobj
        self.isizes = list(isizes)
        self.level = level
        self.header = header
        self.buf = bytearray()
        self.block_i = 0

    def _emit(self, payload: bytes):
        co = zlib.compressobj(self.level, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        self.f.write(self.header)
        self.f.write(comp)
        self.f.write(struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                                 len(payload) & 0xFFFFFFFF))

    def write(self, data: bytes):
        self.buf += data
        while self.block_i < len(self.isizes):
            need = self.isizes[self.block_i]
            if need == 0 or len(self.buf) < need:
                break
            self._emit(bytes(self.buf[:need]))
            del self.buf[:need]
            self.block_i += 1

    def close(self):
        while self.block_i < len(self.isizes):
            need = self.isizes[self.block_i]
            if need == 0:
                self._emit(b"")
                self.block_i += 1
                continue
            assert len(self.buf) >= need, "mgzip-exact: short plaintext"
            self._emit(bytes(self.buf[:need]))
            del self.buf[:need]
            self.block_i += 1
        assert not self.buf, "mgzip-exact: plaintext longer than recorded"
        self.f.close()
