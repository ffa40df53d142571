"""PIZ pipeline: reconstruct the original txt file(s) from a GXZ archive.

Reference parity: src/piz.c:880 piz_one_txt_file / :381 piz_reconstruct_one_vb
— read global area (dicts) once, then per-VB: read + uncompress context
sections, vectorized reconstruction by the datatype plugin, per-VB digest
verification, whole-file digest at the end (src/digest.c:244). Paired (R2)
components resolve "pair-identical" sections from the R1 component and add
R1 GPOS back to delta-coded R2 GPOS (reference src/piz.c:450-544
piz_read_all_ctxs pair loading).
"""

import zlib

import numpy as np

from .contexts import PCtx, parse_dict_payload, MODE_DICT, MODE_NUM, MODE_TXT
from .utils import profiler
from .datatypes import get
from .format import sections as fmt

FLAG_DELTA = 1


class PizReader:
    def __init__(self, z_path: str, reference: str | None = None,
                 password: str | None = None):
        self.f = open(z_path, "rb")
        self.zr = fmt.ZReader(self.f)
        payload, _ = self.zr.read_one(fmt.SEC_FILE_HEADER)
        assert payload is not None, "missing file header"
        self.file_hdr = fmt.json_parse(payload)
        enc = self.file_hdr.get("enc")
        if enc:
            from . import crypt
            assert password, "archive is encrypted — --password required"
            salt = bytes.fromhex(enc["salt"])
            key = crypt.derive_key(password, salt)
            assert crypt.key_tag(key) == enc["tag"], "wrong password"
            self.zr.set_encryption(key, salt)
        self.dt = get(self.file_hdr["dt"])(self.file_hdr.get("segconf") or {})
        if self.file_hdr.get("ref_internal"):
            # REF_INTERNAL: the denovo genome travels in the archive as
            # populated (start, len) ranges (holes reconstruct as code 0)
            payload, _ = self.zr.read_one(fmt.SEC_REFERENCE)
            from .ref.refstore import RefGenome
            from .ops import pack as packops
            ml = int.from_bytes(payload[0:4], "little")
            meta = fmt.json_parse(payload[4:4 + ml])
            off = 4 + ml
            if "ranges" in meta:
                codes = np.zeros(meta["length"], np.uint8)
                for s, l in meta["ranges"]:
                    nb = (l + 3) // 4
                    codes[s:s + l] = packops.unpack_np(
                        np.frombuffer(payload[off:off + nb], np.uint8), 2, l)
                    off += nb
            else:   # legacy whole-genome layout
                pl = int.from_bytes(payload[off:off + 8], "little")
                off += 8
                codes = packops.unpack_np(
                    np.frombuffer(payload[off:off + pl], np.uint8), 2,
                    meta["length"])
            self.dt.ref = RefGenome(codes, meta["contigs"])
        if self.file_hdr.get("ref_stored") and not reference:
            # REF_EXT_STORE: the used genome ranges travel in the archive
            payload, _ = self.zr.read_one(fmt.SEC_REFERENCE)
            from .ref.refstore import RefGenome
            from .ops import pack as packops
            ml = int.from_bytes(payload[0:4], "little")
            meta = fmt.json_parse(payload[4:4 + ml])
            codes = np.zeros(meta["length"], np.uint8)
            off = 4 + ml
            for s, l in meta["ranges"]:
                nb = (l + 3) // 4
                codes[s:s + l] = packops.unpack_np(
                    np.frombuffer(payload[off:off + nb], np.uint8), 2, l)
                off += nb
            self.dt.ref = RefGenome(codes, meta["contigs"])
        elif reference:
            # lazy requirement: metadata-only operations (gxls) work without
            # the reference; recon paths assert when they actually need it
            from .ref.refstore import load_ref_file
            self.dt.ref = load_ref_file(reference)
        elif self.file_hdr.get("reference"):
            self._missing_ref = self.file_hdr["reference"]
        import threading
        self.io_lock = threading.Lock()
        from . import codecs
        self.device = codecs.device_coder()
        # per-component datatype instances (deep archives mix bam + fastq)
        segconf = self.file_hdr.get("segconf") or {}
        self.dts = []
        for comp in self.components():
            cdt = get(comp.get("dt", self.file_hdr["dt"]))(
                comp.get("segconf") or segconf)
            if getattr(self.dt, "ref", None) is not None:
                cdt.ref = self.dt.ref
            self.dts.append(cdt)
        self.deep_index = None
        if self.file_hdr.get("deep"):
            from .deep import DeepIndex
            self.deep_index = DeepIndex()
            for d in self.dts[1:]:
                d.deep_index = self.deep_index
        self.dicts = {}
        for ent in self.zr.sections(fmt.SEC_DICT):
            payload, meta = self.zr.read_section(ent)
            name = ent.dict_id.rstrip(b"\0").decode()
            self.dicts[name] = parse_dict_payload(payload)
        # gencomp (PRIM/DEPN deported-line) state — loaded lazily on the
        # first MAIN-component read so every consumer (unzip, cat, coverage,
        # translations) re-interleaves identically (src/gencomp_piz.c)
        self._gc_loaded = False
        self._gc_prim = self._gc_depn = None

    def _dict(self, name):
        d = self.dicts.get(name)
        if d is None:
            from .utils.ragged import Col
            d = self.dicts[name] = Col.from_list([])  # ctx with zero words
        return d

    def txt_header(self, comp_i: int = 0) -> bytes:
        payload, _ = self.zr.read_one(fmt.SEC_TXT_HEADER, comp_i=comp_i)
        if payload is None:
            payload, _ = self.zr.read_one(fmt.SEC_TXT_HEADER)
        return payload or b""

    def num_vbs(self) -> int:
        return self.file_hdr["num_vbs"]

    def components(self):
        return self.file_hdr.get("components") or [
            {"name": self.file_hdr.get("txt_name"),
             "txt_len": self.file_hdr["txt_len"],
             "adler": self.file_hdr["adler"],
             "num_lines": self.file_hdr["num_lines"]}]

    def _load_ctx_sections(self, vb_i, comp_i, names=None):
        """Read B250/LOCAL payload arrays for a VB. Returns
        {name: {'b250': arr|None, 'local': (arr, ltype)|None}}. With a
        device coder (codecs.device_coder), the rANS streams of a VB's big
        sections decode in one batched call."""
        from . import codecs
        raws = []
        for ent in self.zr.sections(vb_i=vb_i, comp_i=comp_i):
            if ent.sec_type not in (fmt.SEC_B250, fmt.SEC_LOCAL):
                continue
            name = ent.dict_id.rstrip(b"\0").decode()
            if names is not None and name not in names:
                continue
            comp, meta = self.zr.read_section_raw(ent)
            raws.append((ent, name, comp, meta))
        # batched device decode of the rANS streams of the VB's big sections
        payloads = {}
        if self.device is not None:
            subs = {}
            for i, (_, _, comp, meta) in enumerate(raws):
                sub = codecs.rans_substream(comp, meta["codec"])
                if sub is not None and len(sub[0]) >= 6 and \
                        int.from_bytes(sub[0][2:6], "little") >= \
                        codecs.DEVICE_MIN:
                    subs[i] = sub
            if subs:
                with profiler.timer("piz:device-decode"):
                    outs = self.device.decode_many(
                        [sub[0] for sub in subs.values()])
                for (i, (_, finish)), o in zip(subs.items(), outs):
                    meta = raws[i][3]
                    payloads[i] = codecs.checked(
                        finish(o), meta["codec"], meta["uncomp_len"])
        out = {}
        for i, (ent, name, comp, meta) in enumerate(raws):
            payload = payloads.get(i)
            if payload is None:
                payload = codecs.decompress(comp, meta["codec"],
                                            meta["uncomp_len"])
            d = out.setdefault(name, {})
            if ent.sec_type == fmt.SEC_B250:
                d["b250"] = np.frombuffer(
                    payload, fmt.lt_dtype(meta["ltype"])).astype(np.int64)
            else:
                d["local"] = (np.frombuffer(payload, fmt.lt_dtype(meta["ltype"])),
                              meta["ltype"])
        return out

    def load_vb(self, vb_i: int, comp_i: int = 0):
        """I/O + decompress phase (thread-safe under self.io_lock): returns
        everything recon_loaded_vb needs."""
        with self.io_lock:
            payload, _ = self.zr.read_one(fmt.SEC_VB_HEADER, vb_i=vb_i,
                                          comp_i=comp_i)
            if payload is None and comp_i == 0:
                payload, _ = self.zr.read_one(fmt.SEC_VB_HEADER, vb_i=vb_i)
            vb_hdr = fmt.vbhdr_parse(payload)
            with profiler.timer("piz:read+uncompress"):
                sec = self._load_ctx_sections(vb_i, comp_i)
            pair_names = [n for n, cm in vb_hdr["ctxs"].items() if "pair" in cm]
            pair_sec = self._load_ctx_sections(vb_i, 0, pair_names) if pair_names else {}
        return vb_hdr, sec, pair_sec

    def ensure_gencomp(self):
        """Load the PRIM/DEPN line queues + SAG store if the archive has
        gencomp. Idempotent. Every MAIN-component consumer needs this
        before (or via) read_vb so deported lines re-interleave
        (src/sam_sag_load.c)."""
        if self._gc_loaded:
            return self._gc_depn is not None
        self._gc_loaded = True
        gc = self.file_hdr.get("gencomp")
        if not gc:
            return False

        def _read_comp(comp_i, nvbs):
            chunks = [self.read_vb(gvb, comp_i)
                      for gvb in range(1, nvbs + 1)]
            txt = b"".join(chunks)
            return _GcQueue(np.frombuffer(txt, np.uint8), self.dt), txt

        self._gc_prim, prim_txt = _read_comp(1, gc.get("prim_vbs", 0))
        if prim_txt:
            # SAG store before DEPN recon (reference src/sam_sag_load.c)
            self.dt.sag_store = self.dt.build_sag_store(
                np.frombuffer(prim_txt, np.uint8))
        self._gc_depn, _ = _read_comp(2, gc.get("depn_vbs", 0))
        return True

    def merge_vb_gencomp(self, out: bytes, pctxs=None) -> bytes:
        """Re-interleave the just-reconstructed MAIN VB's deported lines
        (vectorized ragged merge — no per-line Python objects). Call
        immediately after recon_loaded_vb on comp 0 (queue order == MAIN
        VB order, so VBs must be consumed or drained sequentially)."""
        from .utils import ragged
        e = np.zeros(0, np.int64)
        if pctxs is None:
            pctxs = self._last_pctxs
        pp = pctxs.get("GPPOS")
        dp = pctxs.get("GCPOS")
        if pp is None and dp is None:
            return out
        prim_pos = pp.nums() if pp is not None else e
        depn_pos = dp.nums() if dp is not None else e
        a = np.frombuffer(out, np.uint8)
        main_col = self.dt.split_records(a)
        n_main = len(main_col)
        total = n_main + prim_pos.shape[0] + depn_pos.shape[0]
        deported = np.zeros(total, bool)
        deported[prim_pos] = True
        deported[depn_pos] = True
        main_idx = np.nonzero(~deported)[0]
        assert main_idx.shape[0] == n_main, "gencomp plan mismatch"
        parts = [(main_idx, main_col)]
        if prim_pos.shape[0]:
            parts.append((prim_pos, self._gc_prim.take(prim_pos.shape[0])))
        if depn_pos.shape[0]:
            parts.append((depn_pos, self._gc_depn.take(depn_pos.shape[0])))
        return ragged.merge_rows(total, parts).data.tobytes()

    def drain_vb_gencomp(self, vb_i: int):
        """Consume a skipped MAIN VB's share of the PRIM/DEPN queues without
        reconstructing it (used by random-access VB skipping)."""
        with self.io_lock:
            sec = self._load_ctx_sections(vb_i, 0, ["GPPOS", "GCPOS"])
        for name, q in (("GPPOS", self._gc_prim), ("GCPOS", self._gc_depn)):
            loc = sec.get(name, {}).get("local")
            if loc is not None:
                q.skip(loc[0].shape[0])

    def read_vb(self, vb_i: int, comp_i: int = 0) -> bytes:
        # gencomp must load BEFORE recon: it reads comps 1/2 (clobbering
        # _last_pctxs) and installs the SAG store the MAIN recon may need
        gc = comp_i == 0 and self.ensure_gencomp()
        out = self.recon_loaded_vb(self.load_vb(vb_i, comp_i), vb_i, comp_i)
        if gc:
            out = self.merge_vb_gencomp(out)
        return out

    def recon_loaded_vb(self, loaded, vb_i: int, comp_i: int = 0,
                        want_pctxs: bool = False):
        """Reconstruct one loaded VB. On any failure, advise the exact
        --biopsy repro command (reference src/piz.c:109-155)."""
        try:
            return self._recon_loaded_vb(loaded, vb_i, comp_i, want_pctxs)
        except Exception as e:
            txt = (self.file_hdr or {}).get("txt_name", "<original-file>")
            advice = (f"to reproduce: gxz zip --biopsy {vb_i} {txt}  "
                      f"(extracts VB {vb_i}'s exact raw text)")
            try:
                e2 = type(e)(f"{e}\n{advice}")
            except Exception:   # exc types with non-str constructors
                e2 = RuntimeError(f"{e!r}\n{advice}")
            raise e2.with_traceback(e.__traceback__) from None

    def _recon_loaded_vb(self, loaded, vb_i: int, comp_i: int = 0,
                         want_pctxs: bool = False):
        vb_hdr, sec, pair_sec = loaded
        pctxs = {}
        for name, cm in vb_hdr["ctxs"].items():
            pc = PCtx(name, cm["mode"], param=cm.get("param", 0),
                      special=cm.get("special"))
            src = sec.get(name, {})
            pair = cm.get("pair")
            if pair == "copy_b250":
                src = {**src, "b250": pair_sec.get(name, {}).get("b250")}
            elif pair == "copy_local":
                src = {**src, "local": pair_sec.get(name, {}).get("local")}
            if cm.get("same") is not None:
                val, cnt = cm["same"]
                pc.b250 = np.full(cnt, val, dtype=np.int64)
                pc.dict_col = self._dict(name)
            elif src.get("b250") is not None:
                pc.b250 = src["b250"]
                pc.dict_col = self._dict(name)
            if src.get("local") is not None:
                pc.local, pc.ltype = src["local"]
            pctxs[name] = pc

        meta = dict(vb_hdr["meta"])
        meta["num_lines"] = vb_hdr["n"]
        if meta.get("gpos_pair_delta") and comp_i == 1:
            self._apply_gpos_pair_delta(pctxs, vb_i)
        dt = self.dts[comp_i] if comp_i < len(self.dts) else self.dt
        self._last_pctxs = pctxs
        with profiler.timer("piz:recon"):
            out = dt.recon_vb(pctxs, meta)
        if self.deep_index is not None and comp_i == 0:
            self.deep_index.add_bam_records(out)
        assert len(out) == vb_hdr["len"], \
            f"VB {vb_i}: length {len(out)} != {vb_hdr['len']}"
        from . import native
        if vb_hdr.get("x64") is not None and native.available():
            assert native.xxh64(out) == vb_hdr["x64"], \
                f"VB {vb_i}: xxh64 digest mismatch"
        else:
            assert zlib.adler32(out) == vb_hdr["adler"], \
                f"VB {vb_i}: digest mismatch"
        return (out, pctxs) if want_pctxs else out

    def _apply_gpos_pair_delta(self, pctxs, vb_i):
        """R2 GPOS was stored as delta vs R1's gpos for reads aligned in both
        (reference fastq_seg_gpos_R2 / fastq_seq.c:187)."""
        with self.io_lock:
            r1 = self._load_ctx_sections(vb_i, 0, ["SQBITMAP", "GPOS"])
        a1 = r1["SQBITMAP"]["local"][0].astype(bool)
        g1 = np.zeros(a1.shape[0], np.int64)
        g1[a1] = r1["GPOS"]["local"][0].astype(np.int64)
        a2 = pctxs["SQBITMAP"].nums().astype(bool)
        both = a2 & a1
        g2 = pctxs["GPOS"].local.astype(np.int64).copy()
        g2 = np.where(both[a2], g2 + g1[a2], g2)
        pctxs["GPOS"].local = g2
        pctxs["GPOS"].param = 0

    def close(self):
        self.f.close()


class _GcQueue:
    """Sequential record queue over a gencomp component's concatenated
    bytes (vectorized: one record-boundary scan via the datatype's
    framing — newlines for SAM, the block_size chain for BAM; take()
    returns a ragged Col slice)."""

    def __init__(self, data: np.ndarray, dt):
        self.col = dt.split_records(data)
        self.cursor = 0

    def take(self, k: int):
        from .utils import ragged
        sub = ragged.take(self.col,
                          np.arange(self.cursor, self.cursor + k))
        self.cursor += k
        return sub

    def skip(self, k: int):
        self.cursor += k


def piz_file(z_path: str, out_path: str | None = None,
             verify_only: bool = False, reference: str | None = None,
             password: str | None = None):
    pr = PizReader(z_path, reference=reference, password=password)
    comps = pr.components()
    total_all = 0

    has_gencomp = pr.ensure_gencomp()
    for comp_i, comp in enumerate(comps):
        path = None
        if out_path:
            if len(comps) == 1:
                path = out_path
            else:
                path = f"{out_path}.{comp_i + 1}"
        sink = None
        if path:
            if path.endswith((".gz", ".bgz", ".bam")):
                from .utils.bgzf import (open_bgzf, ExactBgzfWriter,
                                         MgzipExactWriter)
                mg = pr.file_hdr.get("mgzip")
                isz_payload, _ = pr.zr.read_one(fmt.SEC_GZ_ISIZES)
                from . import native
                lib_kind = (mg or {}).get("lib", "zlib")
                if mg and mg.get("exact") and isz_payload is not None and \
                        (lib_kind == "zlib" or (native.available() and
                                                native.has_libdeflate())):
                    # byte-exact re-emission, any discovered gz dialect +
                    # writer library (reference --bgzf=exact, mgzip.h matrix)
                    isizes = np.frombuffer(isz_payload, "<u4")
                    if mg.get("kind", "bgzf") == "bgzf":
                        sink = ExactBgzfWriter(open(path, "wb"), isizes,
                                               mg["level"],
                                               bytes.fromhex(mg["header"]),
                                               lib=lib_kind)
                    else:
                        sink = MgzipExactWriter(open(path, "wb"), isizes,
                                                mg["level"],
                                                bytes.fromhex(mg["header"]))
                else:
                    sink = open_bgzf(path)
            else:
                sink = open(path, "wb")
        import hashlib
        md5 = hashlib.md5() if (comp_i == 0 and pr.file_hdr.get("md5")) else None
        adler = zlib.adler32(b"")
        total = 0
        hdr = pr.txt_header(comp_i) if comp_i == 0 else b""
        if hdr:
            adler = zlib.adler32(hdr, adler)
            total += len(hdr)
            if sink:
                sink.write(hdr)
        if hdr and md5:
            md5.update(hdr)
        # N-way dispatcher (reference src/dispatcher.c:544 via piz.c:770):
        # workers load+decompress+reconstruct whole VBs concurrently (numpy
        # and the native kernels release the GIL; section reads serialize
        # under io_lock); the main thread drains IN ORDER — gencomp
        # re-interleave, running digest, and the output write are
        # order-dependent (the reference writer-thread role)
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        import os as _os
        nvb = comp.get("num_vbs", pr.num_vbs())
        workers = int(_os.environ.get("GXZ_PIZ_WORKERS", 0)) or \
            min(max(_os.cpu_count() or 2, 1), 8)
        if pr.deep_index is not None and comp_i == 0:
            # deep: the BAM component feeds deep_index IN VB ORDER (FASTQ
            # comps reference SAM lines by running index) — keep it serial
            workers = 1

        def work(vb_i):
            loaded = pr.load_vb(vb_i, comp_i)
            with profiler.timer("piz:recon"):
                return pr.recon_loaded_vb(loaded, vb_i, comp_i,
                                          want_pctxs=True)

        with ThreadPoolExecutor(max_workers=workers) as pool:
            inflight = deque()
            for vb_i in range(1, nvb + 1):
                inflight.append(pool.submit(work, vb_i))
                while len(inflight) > workers:
                    out, pctxs = inflight.popleft().result()
                    with profiler.timer("piz:drain"):
                        if has_gencomp and comp_i == 0:
                            out = pr.merge_vb_gencomp(out, pctxs)
                        adler = zlib.adler32(out, adler)
                        if md5:
                            md5.update(out)
                        total += len(out)
                        if sink:
                            sink.write(out)
            while inflight:
                out, pctxs = inflight.popleft().result()
                with profiler.timer("piz:drain"):
                    if has_gencomp and comp_i == 0:
                        out = pr.merge_vb_gencomp(out, pctxs)
                    adler = zlib.adler32(out, adler)
                    if md5:
                        md5.update(out)
                    total += len(out)
                    if sink:
                        sink.write(out)
        assert total == comp["txt_len"], f"component {comp_i}: length mismatch"
        if comp.get("adler") is not None:
            assert adler == comp["adler"], f"component {comp_i}: digest mismatch"
        if md5 is not None:
            assert md5.hexdigest() == pr.file_hdr["md5"], "MD5 mismatch"
        if sink:
            sink.close()
        total_all += total
    pr.close()
    return total_all
