"""GXZ archive container format: section framing, writer and reader.

Reference parity: src/sections.h (section headers), src/zfile.c:288-366
(zfile_compress_*), src/zfile.c:899 (backward footer read). Re-designed
minimally for this engine (our own format — no genozip interop): every
section is [64-byte header | compressed payload]; the file ends with a
compressed section index + fixed 40-byte tail that is read backwards at PIZ.

Layout of a single-component file:
  FILE_HEADER (json metadata incl. segconf)
  TXT_HEADER (per component)
  per VB: VB_HEADER, then B250/LOCAL sections per context
  global area: DICT per context, COUNTS, RANDOM_ACCESS, STATS, REFERENCE...
  FOOTER: section index (packed struct array, zlib) + tail
"""

import io
import json
import struct
import zlib

import numpy as np

from .. import codecs

MAGIC = 0x315A5847  # "GXZ1"
TAIL_MAGIC = b"GXZfoot1"

# section types
SEC_FILE_HEADER = 0
SEC_TXT_HEADER = 1
SEC_VB_HEADER = 2
SEC_B250 = 3
SEC_LOCAL = 4
SEC_DICT = 5
SEC_COUNTS = 6
SEC_RANDOM_ACCESS = 7
SEC_STATS = 8
SEC_REFERENCE = 9
SEC_REF_HASH = 10
SEC_REF_CONTIGS = 11
SEC_RECON_PLAN = 12
# 13 reserved: the reference's SEC_HUFFMAN (huffman.c canonical tables for
# in-memory SAG/QNAME compaction) is deliberately superseded here — wide
# rANS covers the on-disk role and the SAG store's fixed-width bit-packing
# (sag.py) covers the random-access in-memory role, which is exactly where
# byte-serial canonical huffman would fight the vectorized design.
SEC_GENCOMP = 14
SEC_REF_IUPACS = 15
SEC_GZ_ISIZES = 16

SEC_NAMES = {v: k for k, v in list(globals().items()) if k.startswith("SEC_")}

# local types (ltype) — dtype of LOCAL payloads (reference src/local_type.h:14-57)
LT_U8, LT_U16, LT_U32, LT_U64, LT_I8, LT_I16, LT_I32, LT_I64, LT_F32, LT_F64, LT_TXT = range(11)
_LT_DTYPE = {LT_U8: "<u1", LT_U16: "<u2", LT_U32: "<u4", LT_U64: "<u8",
             LT_I8: "<i1", LT_I16: "<i2", LT_I32: "<i4", LT_I64: "<i8",
             LT_F32: "<f4", LT_F64: "<f8", LT_TXT: "<u1"}


def lt_dtype(ltype: int):
    return np.dtype(_LT_DTYPE[ltype])


def lt_for_dtype(dt) -> int:
    s = np.dtype(dt).str.lstrip("<>|=")
    return {"u1": LT_U8, "u2": LT_U16, "u4": LT_U32, "u8": LT_U64,
            "i1": LT_I8, "i2": LT_I16, "i4": LT_I32, "i8": LT_I64,
            "f4": LT_F32, "f8": LT_F64}[s]


# header: magic, sec_type, codec, flags, ltype, vb_i, comp_i, dict_id,
#         uncomp_len, comp_len, param, adler  -> 64 bytes
# (dict_id is 16 bytes — the reference's 8-byte DictId truncates long
# sub-context names, which silently aliases sections; 16 covers every
# generated name: tag + family suffix + position index)
_HDR = struct.Struct("<IBBBBIi16sQQQI4x")
HDR_SIZE = _HDR.size
assert HDR_SIZE == 64

_TAIL = struct.Struct("<QQQ8s")  # index_offset, index_comp_len, file_size, magic
TAIL_SIZE = _TAIL.size

# section index entry: sec_type, vb_i, comp_i, dict_id, offset
_IDX = struct.Struct("<BxxxIi16sQ")


def norm_dict_id(dict_id) -> bytes:
    if isinstance(dict_id, str):
        dict_id = dict_id.encode()
    dict_id = dict_id or b""
    # a silent truncation would alias two contexts' sections (e.g. "X" and
    # "XS" colliding at 16 bytes) — that corrupts archives quietly, so the
    # writer refuses; seg code must generate names that fit
    assert len(dict_id) <= 16, f"context name too long for dict_id: {dict_id!r}"
    return dict_id.ljust(16, b"\0")


class SectionEnt:
    __slots__ = ("sec_type", "vb_i", "comp_i", "dict_id", "offset")

    def __init__(self, sec_type, vb_i, comp_i, dict_id, offset):
        self.sec_type, self.vb_i, self.comp_i = sec_type, vb_i, comp_i
        self.dict_id, self.offset = dict_id, offset

    def __repr__(self):
        return (f"<{SEC_NAMES.get(self.sec_type)} vb={self.vb_i} "
                f"comp={self.comp_i} {self.dict_id.rstrip(b'\\0')} @{self.offset}>")


class ZWriter:
    """Writes sections sequentially; finalize() emits the footer.
    (The reference's zriter background-flush becomes plain buffered writes —
    ordering is decided by the caller, cf. src/zriter.c.)"""

    def __init__(self, fileobj):
        self.f = fileobj
        self.offset = 0
        self.index = []
        self.crypt_key = None
        self.crypt_salt = None

    def set_encryption(self, key: bytes, salt: bytes):
        self.crypt_key, self.crypt_salt = key, salt

    def write_section(self, sec_type, payload: bytes, *, codec=codecs.NONE,
                      vb_i=0, comp_i=-1, dict_id=b"", ltype=LT_TXT, param=0,
                      flags=0, precompressed=None, uncomp_len=None):
        """Compress (or accept precompressed) payload and append a section."""
        if precompressed is not None:
            comp = precompressed
            assert uncomp_len is not None
        else:
            uncomp_len = len(payload)
            comp = codecs.compress(payload, codec)
        adl = zlib.adler32(comp) & 0xFFFFFFFF  # over plaintext-compressed
        if self.crypt_key is not None and sec_type != SEC_FILE_HEADER:
            from .. import crypt
            comp = crypt.crypt_payload(self.crypt_key, self.crypt_salt,
                                       self.offset, comp)
            flags |= crypt.FLAG_ENCRYPTED
        did = norm_dict_id(dict_id)
        hdr = _HDR.pack(MAGIC, sec_type, codec, flags, ltype, vb_i, comp_i,
                        did, uncomp_len, len(comp), param, adl)
        self.index.append(SectionEnt(sec_type, vb_i, comp_i, did, self.offset))
        self.f.write(hdr)
        self.f.write(comp)
        self.offset += HDR_SIZE + len(comp)
        return self.index[-1]

    def finalize(self):
        idx_raw = b"".join(
            _IDX.pack(e.sec_type, e.vb_i, e.comp_i, e.dict_id, e.offset)
            for e in self.index)
        idx_comp = zlib.compress(idx_raw, 6)
        idx_offset = self.offset
        self.f.write(idx_comp)
        file_size = idx_offset + len(idx_comp) + TAIL_SIZE
        self.f.write(_TAIL.pack(idx_offset, len(idx_comp), file_size, TAIL_MAGIC))
        self.f.flush()


class ZReader:
    """Random-access section reader driven by the footer index
    (reference src/zfile.c:899 zfile_read_genozip_header reads backwards)."""

    def __init__(self, fileobj):
        self.f = fileobj
        self.f.seek(0, io.SEEK_END)
        file_size = self.f.tell()
        if file_size < TAIL_SIZE:
            raise ValueError("not a GXZ file (too small)")
        self.f.seek(file_size - TAIL_SIZE)
        idx_offset, idx_len, fsz, magic = _TAIL.unpack(self.f.read(TAIL_SIZE))
        if magic != TAIL_MAGIC or fsz != file_size:
            raise ValueError("not a GXZ file (bad footer)")
        self.f.seek(idx_offset)
        idx_raw = zlib.decompress(self.f.read(idx_len))
        self.index = [SectionEnt(*_IDX.unpack(idx_raw[i:i + _IDX.size]))
                      for i in range(0, len(idx_raw), _IDX.size)]
        self.crypt_key = None
        self.crypt_salt = None

    def set_encryption(self, key: bytes, salt: bytes):
        self.crypt_key, self.crypt_salt = key, salt

    def sections(self, sec_type=None, vb_i=None, comp_i=None):
        out = self.index
        if sec_type is not None:
            out = [e for e in out if e.sec_type == sec_type]
        if vb_i is not None:
            out = [e for e in out if e.vb_i == vb_i]
        if comp_i is not None:
            out = [e for e in out if e.comp_i == comp_i]
        return out

    def read_section_raw(self, ent: SectionEnt):
        """Returns (compressed_bytes, header_dict) — decrypted and digest-
        checked, NOT decompressed (batched device decoding decompresses
        many sections in one kernel launch)."""
        self.f.seek(ent.offset)
        hdr = _HDR.unpack(self.f.read(HDR_SIZE))
        (magic, sec_type, codec, flags, ltype, vb_i, comp_i, did,
         uncomp_len, comp_len, param, adler) = hdr
        assert magic == MAGIC, "corrupt section header"
        comp = self.f.read(comp_len)
        if flags & 2:  # FLAG_ENCRYPTED
            from .. import crypt
            assert self.crypt_key is not None, \
                "archive is encrypted — password required"
            comp = crypt.crypt_payload(self.crypt_key, self.crypt_salt,
                                       ent.offset, comp)
        assert (zlib.adler32(comp) & 0xFFFFFFFF) == adler, \
            f"section digest mismatch at {ent!r} (wrong password?)"
        meta = dict(sec_type=sec_type, codec=codec, flags=flags, ltype=ltype,
                    vb_i=vb_i, comp_i=comp_i, dict_id=did, param=param,
                    comp_len=comp_len, uncomp_len=uncomp_len)
        return comp, meta

    def read_section(self, ent: SectionEnt):
        """Returns (payload_bytes, header_dict)."""
        comp, meta = self.read_section_raw(ent)
        payload = codecs.decompress(comp, meta["codec"], meta["uncomp_len"])
        return payload, meta

    def read_one(self, sec_type, vb_i=None, comp_i=None, dict_id=None):
        ents = self.sections(sec_type, vb_i, comp_i)
        if dict_id is not None:
            did = norm_dict_id(dict_id)
            ents = [e for e in ents if e.dict_id == did]
        if not ents:
            return None, None
        return self.read_section(ents[0])


def json_payload(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def json_parse(payload: bytes):
    return json.loads(payload.decode())


# --- compact binary VB header (format v2) ---------------------------------
# The per-VB hot-path header; JSON stays for the file header. Layout:
#   0xB2 | n u32 | len u64 | adler u32 | has_x64 u8 [| x64 u64] | nctx u16
#   per ctx: nlen u8 | name | mode u8 | flags u8
#            [param i32] [slen u8 + special] [same: v i64 + count u32]
#            [pair u8 (0=copy_b250 1=copy_local)]
#   meta: rest = JSON blob (datatype-specific, usually tiny)
# v1 (JSON) archives back-read transparently: their payload starts with '{'.

_VBH_MAGIC = 0xB2
_MODES = ["dict", "num", "txt", "special"]
_MODE_ID = {m: i for i, m in enumerate(_MODES)}


def vbhdr_pack(d: dict) -> bytes:
    out = bytearray([_VBH_MAGIC])
    out += struct.pack("<IQI", d["n"], d["len"], d["adler"] & 0xFFFFFFFF)
    x64 = d.get("x64")
    if x64 is not None:
        out += b"\x01" + struct.pack("<Q", x64 & ((1 << 64) - 1))
    else:
        out += b"\x00"
    ctxs = d["ctxs"]
    out += struct.pack("<H", len(ctxs))
    for name, cm in ctxs.items():
        nb = name.encode()
        out += bytes([len(nb)]) + nb + bytes([_MODE_ID[cm["mode"]]])
        param = cm.get("param", 0)
        special = cm.get("special")
        same = cm.get("same")
        pair = cm.get("pair")
        flags = ((1 if param else 0) | (2 if special is not None else 0) |
                 (4 if same is not None else 0) |
                 (8 if pair is not None else 0))
        out += bytes([flags])
        if param:
            out += struct.pack("<i", param)
        if special is not None:
            sb = str(special).encode()
            out += bytes([len(sb)]) + sb
        if same is not None:
            out += struct.pack("<qI", int(same[0]), int(same[1]))
        if pair is not None:
            out += bytes([0 if pair == "copy_b250" else 1])
    out += json_payload(d.get("meta") or {})
    return bytes(out)


def vbhdr_parse(payload: bytes) -> dict:
    if payload[:1] == b"{":          # format v1: plain JSON
        return json_parse(payload)
    mv = memoryview(payload)
    assert mv[0] == _VBH_MAGIC, "bad VB header magic"
    n, ln, adler = struct.unpack_from("<IQI", mv, 1)
    off = 17
    d = {"n": n, "len": ln, "adler": adler}
    if mv[off]:
        d["x64"] = struct.unpack_from("<Q", mv, off + 1)[0]
        off += 9
    else:
        off += 1
    nctx, = struct.unpack_from("<H", mv, off)
    off += 2
    ctxs = {}
    for _ in range(nctx):
        nl = mv[off]
        name = bytes(mv[off + 1:off + 1 + nl]).decode()
        off += 1 + nl
        cm = {"mode": _MODES[mv[off]]}
        flags = mv[off + 1]
        off += 2
        if flags & 1:
            cm["param"], = struct.unpack_from("<i", mv, off)
            off += 4
        if flags & 2:
            sl = mv[off]
            cm["special"] = bytes(mv[off + 1:off + 1 + sl]).decode()
            off += 1 + sl
        if flags & 4:
            v, c = struct.unpack_from("<qI", mv, off)
            cm["same"] = [v, c]
            off += 12
        if flags & 8:
            cm["pair"] = "copy_b250" if mv[off] == 0 else "copy_local"
            off += 1
        ctxs[name] = cm
    d["ctxs"] = ctxs
    d["meta"] = json_parse(bytes(mv[off:])) if off < len(mv) else {}
    return d
