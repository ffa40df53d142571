"""ZIP pipeline: compress txt file(s) into a GXZ archive.

Reference parity: src/zip.c:721 zip_one_file / :510 zip_compress_one_vb —
per-VB seg → deterministic in-order dict merge → per-context codec
auto-assignment (committed on first sight, src/codec.c:210) → section write;
global area (dicts, counts, random access, file header) at the end, cf.
zip.c:416 zip_write_global_area. `zip_pair` implements R1/R2 FASTQ
co-compression (reference src/fastq.c:224-245): R2 VBs are built 1:1 with R1
VBs by read count, byte-identical R2 sections are dropped ("pair-identical",
zip.c:223-234) and R2 GPOS is delta-coded against R1's ("pair-assisted").
"""

import time
import zlib

import numpy as np

from . import codecs
from .codecs import assign as codec_assign
from .utils import profiler
from .contexts import ZCtxGlobal, VBCtx, MODE_NUM, narrow_int
from .datatypes import detect, get
from .format import sections as fmt
from .txtfile import TxtReader, DEFAULT_VB_SIZE

FLAG_DELTA = 1


class ZipStats:
    def __init__(self):
        self.txt_len = 0
        self.z_len = 0
        self.num_vbs = 0
        self.num_lines = 0
        self.start = time.time()
        self.per_ctx = {}  # name -> [txt-ish bytes, z bytes]

    def add_section(self, name, uncomp, comp):
        e = self.per_ctx.setdefault(name, [0, 0])
        e[0] += uncomp
        e[1] += comp


class ZipJob:
    """Shared state for writing one archive (possibly multiple components)."""

    def __init__(self, out_path: str):
        self.out = open(out_path, "wb")
        self.zw = fmt.ZWriter(self.out)
        self.gctxs: dict[str, ZCtxGlobal] = {}
        self.stats = ZipStats()
        self.ra_index = {}
        self.components = []
        self.device = codecs.device_coder()

    def precommit_codecs(self, res):
        """Segconf codec pre-commitment (reference segconf.c:459 +
        codec.c:210): assign each calibration-VB context's codec ONCE
        before the fan-out, so VB 1's serial drain carries no trials.
        The VB counter is reset so the VB-10 retest still lands on the
        real 10th VB."""
        for name, c in res.ctxs.items():
            g = self.gctxs.get(name)
            if g is None:
                g = self.gctxs[name] = ZCtxGlobal(name)
            try:
                if c.b250 is not None:
                    g.pick_codec("b250", narrow_int(c.b250).tobytes(),
                                 "b250")
                if c.local is not None:
                    arr = narrow_int(c.local) if c.mode == "num" else c.local
                    g.pick_codec("local", arr.tobytes(), c.cat)
            except Exception:
                pass        # calibration must never break the pipeline
            g.codec_nvb = {}

    def precompress_locals(self, res):
        """Worker-side compression of local sections whose codec is already
        committed (reference zip.c:566 zip_compress_all_contexts_local runs
        in the compute thread). Returns {name: (codec, arr, payload, blob)};
        build_vb consumes it when the main-thread codec decision agrees.
        Reads committed codecs without taking them — commit/counting stays
        in the ordered main-thread drain, so archives remain deterministic."""
        pre, dev = {}, {}
        for name, c in res.ctxs.items():
            if c.local is None:
                continue
            g = self.gctxs.get(name)
            if g is None or g.local_codec is None:
                continue
            if g.codec_nvb.get("local", 0) == 9 and \
                    codec_assign._mode != "fast":
                continue        # next pick_codec call is the VB-10 retest
            codec = g.local_codec
            arr = narrow_int(c.local) if c.mode == "num" else c.local
            payload = arr.tobytes()
            if self._on_device(codec, payload):
                dev[name] = (codec, arr, payload)
                continue
            try:
                blob = codecs.compress(payload, codec)
            except Exception:
                continue
            pre[name] = (codec, arr, payload, blob)
        if dev:
            blobs = self._device_encode(
                {name: (codec, payload) for name, (codec, _, payload)
                 in dev.items()})
            for name, (codec, arr, payload) in dev.items():
                pre[name] = (codec, arr, payload, blobs[name])
        return pre

    def _on_device(self, codec, payload) -> bool:
        """Whether this section is offered to the device coder."""
        return self.device is not None and codec in codecs.RANS_STAGED \
            and len(payload) >= codecs.DEVICE_MIN

    def _device_encode(self, entries):
        """{key: (codec, payload)} -> {key: blob}: rANS streams of at least
        DEVICE_MIN symbols go through one device call (streams equal the
        host coder's), the rest compress on the host."""
        out, dev = {}, {}
        for key, (codec, payload) in entries.items():
            stage = codecs.rans_stage(payload, codec)
            if len(stage[0]) >= codecs.DEVICE_MIN:
                dev[key] = stage
            else:
                out[key] = codecs.compress(payload, codec)
        if dev:
            with profiler.timer("zip:device-encode"):
                streams = self.device.encode_many(
                    [stage[:2] for stage in dev.values()])
            for (key, stage), stream in zip(dev.items(), streams):
                out[key] = stage[2](stream)
        return out

    def write_vb(self, res, data, vb_i, comp_i, pair_payloads=None,
                 collect=False, pre_locals=None):
        """Write one VB's sections. pair_payloads: comp-0 payload map for
        pair-identical dropping. collect=True returns {name: payload} map."""
        built = self.build_vb(res, data, vb_i, comp_i, pair_payloads, collect,
                              pre_locals)
        self.flush_vb(built)
        return built["out_payloads"]

    def build_vb(self, res, data, vb_i, comp_i, pair_payloads=None,
                 collect=False, pre_locals=None):
        """Phase 1: dict merge (VB order = determinism) + section planning.
        No compression happens here, so a dp batch of built VBs can route
        their payloads through ONE sharded device kernel before flushing
        (parallel/zip_sharded.ShardedZipEncoder)."""
        out_payloads = {} if collect else None
        ctx_meta = {}

        # random-access index (reference src/random_access.c)
        cctx = res.ctxs.get("CHROM") or res.ctxs.get("RNAME")
        pctx = res.ctxs.get("POS")
        if cctx is not None and pctx is not None and \
                cctx.b250 is not None and pctx.local is not None:
            from . import regions as regions_mod
            pv = pctx.local
            if pctx.param == 1:
                pv = np.cumsum(pv)
            ents = regions_mod.ra_entries(cctx.vb_words, cctx.b250, pv)
            if ents:
                self.ra_index[f"{comp_i}:{vb_i}"] = ents

        # (sec_type, name, payload, codec, ltype, flags, units, blob|None)
        pending = []
        for name, c in res.ctxs.items():
            g = self.gctxs.get(name)
            if g is None:
                g = self.gctxs[name] = ZCtxGlobal(name)
            ctx_meta[name] = c.meta()
            if c.b250 is not None:
                counts = np.bincount(c.b250, minlength=len(c.vb_words))
                lut = g.merge_words(c.vb_words, counts)
                b250_g = lut[c.b250]
                payload_arr = narrow_int(b250_g)
                payload = payload_arr.tobytes()
                key = (name, fmt.SEC_B250)
                all_same = b250_g.shape[0] and (b250_g == b250_g[0]).all()
                if collect:
                    # elided sections can't serve as pair-copy sources
                    out_payloads[key] = None if all_same else payload
                if all_same:
                    # all-the-same: no section, value+count ride in the VB
                    # header (reference ctx_drop_all_the_same, context.c)
                    ctx_meta[name]["same"] = [int(b250_g[0]),
                                              int(b250_g.shape[0])]
                elif pair_payloads is not None and \
                        pair_payloads.get(key) == payload:
                    ctx_meta[name]["pair"] = "copy_b250"
                else:
                    codec = g.pick_codec("b250", payload, "b250")
                    pending.append((fmt.SEC_B250, name, payload, codec,
                                    fmt.lt_for_dtype(payload_arr.dtype), 0,
                                    int(c.b250.shape[0]), None))
            if c.local is not None:
                pc = (pre_locals or {}).get(name)
                if pc is not None:
                    local, payload = pc[1], pc[2]
                else:
                    local = c.local
                    if c.mode == "num":
                        local = narrow_int(local)
                    payload = local.tobytes()
                key = (name, fmt.SEC_LOCAL)
                if collect:
                    out_payloads[key] = payload
                if pair_payloads is not None and pair_payloads.get(key) == payload:
                    ctx_meta[name]["pair"] = "copy_local"
                else:
                    codec = g.pick_codec("local", payload, c.cat)
                    blob = pc[3] if pc is not None and pc[0] == codec else None
                    pending.append((fmt.SEC_LOCAL, name, payload,
                                    codec, fmt.lt_for_dtype(local.dtype),
                                    FLAG_DELTA if c.param == 1 else 0,
                                    len(payload), blob))

        vb_hdr = {"n": res.num_lines, "len": int(data.shape[0]),
                  "adler": zlib.adler32(data), "ctxs": ctx_meta,
                  "meta": res.meta}
        from . import native
        if native.available():
            # 64-bit per-VB digest (reference digest.c XXH3-since-15.0.81
            # role; adler32 stays as the no-native fallback check)
            vb_hdr["x64"] = native.xxh64(data)
        return {"pending": pending, "vb_hdr": vb_hdr, "vb_i": vb_i,
                "comp_i": comp_i, "data_len": int(data.shape[0]),
                "num_lines": res.num_lines, "out_payloads": out_payloads}

    def flush_vb(self, built, precomp=None):
        """Phase 2: compress (host, or take dp-batch precompressed blobs)
        and write the VB's sections + header."""
        zw, stats = self.zw, self.stats
        pending = built["pending"]
        vb_i, comp_i = built["vb_i"], built["comp_i"]
        if precomp is None:
            # the VB's big sections not coded by a seg worker (b250s, first
            # sight) in one batch
            precomp = self._device_encode(
                {i: (e[3], e[2]) for i, e in enumerate(pending)
                 if e[7] is None and self._on_device(e[3], e[2])})

        for i, (sec, name, payload, codec, ltype, flags, units, blob) in \
                enumerate(pending):
            pc = precomp.get(i)
            if pc is None:
                pc = blob
            ent = zw.write_section(
                sec, payload, codec=codec, vb_i=vb_i, comp_i=comp_i,
                dict_id=name, ltype=ltype, flags=flags,
                precompressed=pc,
                uncomp_len=len(payload) if pc is not None else None)
            stats.add_section(name, units, zw.offset - ent.offset)

        zw.write_section(fmt.SEC_VB_HEADER, fmt.vbhdr_pack(built["vb_hdr"]),
                         codec=codecs.ZLIB, vb_i=vb_i, comp_i=comp_i)
        stats.txt_len += built["data_len"]
        stats.num_vbs += 1
        stats.num_lines += built["num_lines"]

    def write_global_area(self, file_hdr):
        zw = self.zw
        for name, g in self.gctxs.items():
            if len(g):
                payload = g.dict_payload()
                codec = codec_assign.assign_best(payload, "text")
                at = zw.offset
                zw.write_section(fmt.SEC_DICT, payload, codec=codec, dict_id=name)
                # dict bytes count toward the owning context's stats row
                # (reference stats.c attributes SEC_DICT per context)
                self.stats.add_section(name, len(payload), zw.offset - at)
                cnt = np.asarray(g.counts, dtype="<u8").tobytes()
                zw.write_section(fmt.SEC_COUNTS, cnt,
                                 codec=codec_assign.assign_best(cnt, "int"),
                                 dict_id=name, ltype=fmt.LT_U64)
        # per-context compressed-size accounting (reference src/stats.c ->
        # SEC_STATS, readable via `gxls --stats`) — written after dicts so
        # their sizes are included
        zw.write_section(fmt.SEC_STATS, fmt.json_payload(self.stats.per_ctx),
                         codec=codecs.ZLIB)
        if self.ra_index:
            zw.write_section(fmt.SEC_RANDOM_ACCESS,
                             fmt.json_payload(self.ra_index), codec=codecs.ZLIB)
        zw.write_section(fmt.SEC_FILE_HEADER, fmt.json_payload(file_hdr),
                         codec=codecs.ZLIB)
        zw.finalize()
        self.out.close()
        self.stats.z_len = zw.offset


def _maybe_write_internal_ref(job, dt, reference) -> bool:
    """REF_INTERNAL (src/reference.c): store the denovo genome built from
    the alignments so PIZ reconstructs SEQ without any external reference.
    Payload: contigs json + 2-bit codes + is_set bitmap."""
    iref = getattr(dt, "ref", None)
    if reference is not None or iref is None or \
            not getattr(iref, "internal", False) or not iref.is_set.any():
        return False
    from .ops import pack as packops
    # is_set compaction (reference src/sections.h:437-450 SEC_REFERENCE
    # range compaction): store only populated 4KB blocks as (start, len)
    # ranges — unpopulated contigs/holes cost nothing
    blk = getattr(dt, "_POP_BLK", 4096)
    if getattr(iref, "blk_set", None) is not None:
        pop = iref.blk_set > 0
    else:
        nblk = -(-iref.length // blk)
        pad = nblk * blk - iref.length
        is_set = np.concatenate([iref.is_set[:iref.length],
                                 np.zeros(pad, bool)])
        pop = is_set.reshape(-1, blk).any(axis=1)
    d = np.diff(np.concatenate([[0], pop.view(np.int8), [0]]).astype(np.int8))
    rs = np.nonzero(d == 1)[0] * blk
    re_ = np.nonzero(d == -1)[0] * blk
    ranges = [(int(s), int(min(e, iref.length) - s)) for s, e in zip(rs, re_)]
    meta = fmt.json_payload({"contigs": iref.contigs,
                             "length": int(iref.length),
                             "ranges": ranges})
    packed = b"".join(packops.pack_np(iref.codes[s:s + l], 2).tobytes()
                      for s, l in ranges)
    payload = len(meta).to_bytes(4, "little") + meta + packed
    job.zw.write_section(fmt.SEC_REFERENCE, payload,
                         codec=codec_assign.assign_best(payload, "text"))
    return True


def _maybe_write_stored_ref(job, dt, reference, store_ref) -> bool:
    """REF_EXT_STORE (src/reference.c / flags.h:16-21 --REFERENCE mode):
    with an external reference, also embed the genome ranges the file
    actually used, so unzip needs no .ref file. Payload: contigs json +
    (start, len) ranges + concatenated 2-bit codes per range."""
    ref = getattr(dt, "ref", None)
    if not store_ref or not reference or ref is None:
        return False
    ranges = ref.used_ranges()
    if not ranges:
        return False
    from .ops import pack as packops
    meta = fmt.json_payload({"contigs": ref.contigs,
                             "length": int(ref.length),
                             "ranges": [[int(s), int(l)] for s, l in ranges]})
    packed = b"".join(packops.pack_np(ref.codes[s:s + l], 2).tobytes()
                      for s, l in ranges)
    payload = len(meta).to_bytes(4, "little") + meta + packed
    job.zw.write_section(fmt.SEC_REFERENCE, payload,
                         codec=codec_assign.assign_best(payload, "text"))
    return True


def _setup_encryption(job, password):
    if not password:
        return None
    from . import crypt
    salt = crypt.new_salt()
    key = crypt.derive_key(password, salt)
    job.zw.set_encryption(key, salt)
    return {"salt": salt.hex(), "tag": crypt.key_tag(key)}


def _open_component(in_path, dt_name, reference, truncate=False):
    reader = TxtReader(in_path, truncate=truncate)
    head = reader.peek(64 * 1024)
    dt_name = dt_name or detect(in_path, head)
    dt = get(dt_name)()
    if reference:
        from .ref.refstore import load_ref_file
        dt.ref = load_ref_file(reference)
    dt.segconf_scan(np.frombuffer(head, dtype=np.uint8))
    # plaintext size estimate for vb_size auto-tuning (segconf.c:101):
    # compressed inputs assume the typical ~3x gz ratio of genomic text
    if reader.disk_size:
        est = reader.disk_size * (3 if reader.is_compressed else 1)
        dt.segconf["txt_size_est"] = int(est)
    return reader, dt, dt_name


def zip_file(in_path: str, out_path: str, dt_name: str | None = None,
             vb_size: int | None = None, show_stats: bool = False,
             reference: str | None = None, password: str | None = None,
             use_md5: bool = False, bamass: str | None = None,
             truncate: bool = False, mesh: int | None = None,
             dp: int | None = None, store_ref: bool = False,
             threads: int | None = None, optimize: bool = False):
    reader, dt, dt_name = _open_component(in_path, dt_name, reference,
                                          truncate=truncate)
    dt.optimize_enabled = optimize
    if store_ref and getattr(dt, "ref", None) is not None:
        dt.ref.track_used = True  # REF_EXT_STORE usage tracking
    if mesh and getattr(dt, "ref", None) is not None:
        # sharded aligner: genome+refhash over 'mp', read batches over 'dp'
        from .parallel.mesh_aligner import MeshAligner
        dt.mesh_aligner = MeshAligner(dt.ref, n_devices=mesh)
    if bamass:
        assert reference, "--bamass needs --reference"
        from .bamass import build_index
        dt.bamass_index = build_index(bamass, dt.ref)
    if vb_size is None:
        # None = caller didn't choose: segconf's size-aware suggestion,
        # else the default. An explicit value (CLI --vblock) always wins.
        vb_size = dt.suggested_vb_size() or DEFAULT_VB_SIZE
    job = ZipJob(out_path)
    enc = _setup_encryption(job, password)

    import hashlib
    md5 = hashlib.md5() if use_md5 else None
    txt_header = dt.read_txt_header(reader)
    file_adler = zlib.adler32(b"")
    if txt_header:
        file_adler = zlib.adler32(txt_header, file_adler)
        if md5:
            md5.update(txt_header)
        codec = codec_assign.assign_best(txt_header, "text")
        job.zw.write_section(fmt.SEC_TXT_HEADER, txt_header, codec=codec, comp_i=0)
        job.stats.txt_len += len(txt_header)

    # segconf calibration seg (reference segconf.c:459 segconf_calculate):
    # seg a ~1MB sample to (a) commit the per-file lazy seg choices (QUAL
    # demux class, CSQ/int-list/ID layout trials) on cheap data and (b)
    # pre-commit every sampled context's codec — VB 1 still drains alone
    # (the determinism anchor for stragglers) but its serial work is now
    # just seg. Under REF_INTERNAL the denovo genome must not be
    # pre-populated out of replay order, so calibration runs with the ref
    # detached (SEQ goes verbatim; QUAL/aux/layout choices still commit).
    cal = reader.peek(1 << 20)
    if cal:
        cdata = np.frombuffer(cal, np.uint8)
        cut = dt.vb_boundary(cdata, False)
        if 0 < cut:
            iref = getattr(dt, "ref", None)
            internal = getattr(iref, "internal", False)
            if internal:
                dt.ref = None
            try:
                with profiler.timer("zip:segconf-cal"):
                    cres = dt.seg_vb(cdata[:cut].copy())
                job.precommit_codecs(cres)
            except Exception:
                pass    # calibration must never break the real path
            finally:
                if internal:
                    dt.ref = iref

    # from here on seg runs concurrently: per-file trial-once choices are
    # final (frozen regardless of worker count — bytes must match across
    # thread counts, the test_determinism.py guarantee)
    dt.freeze_lazy_choices()

    from .utils.progress import Progress
    prog = Progress(f"zip {in_path.rsplit('/', 1)[-1]}", None)

    # N-way dispatcher (reference src/dispatcher.c:544 fan-out analog):
    # up to `workers` VBs seg concurrently on a thread pool while the main
    # thread merges/codes/writes completed VBs strictly in VB order (FIFO
    # drain) — dict merge order = determinism. numpy and the native coder
    # release the GIL, so all host cores stay busy; in-flight VBs are
    # bounded by the pool width (the reference's vb_pool analog).
    import os as _os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    workers = threads or int(_os.environ.get("GXZ_THREADS", "0")) \
        or (_os.cpu_count() or 2)
    if getattr(getattr(dt, "ref", None), "internal", False):
        # REF_INTERNAL: seg of VB n populates the denovo genome that VB n+1
        # diffs against (first-writer-wins scatter) — PIZ replays the same
        # order, so seg must stay sequential (ref_lock.c's serialization)
        workers = 1
    vb_i = 0
    prim_parts = []      # deported PRIM text (reference gencomp_zip.c)
    depn_parts = []      # deported DEPN text
    use_gencomp = dt_name in ("sam", "bam") and hasattr(dt, "gencomp_split")
    depn_qnames = None
    # segconf gates the prescan pass: a sample with no secondary/
    # supplementary flags skips the extra streaming read (segconf.c role);
    # DEPN appearing later still deports per-VB (DEPN-only mode)
    if use_gencomp and not dt.segconf.get("has_depn", True):
        use_gencomp = False
    if use_gencomp and dt.segconf.get("depn_prim_pairs", True):
        # prescan: which qnames have dependents (reference sam_sag_scan.c) —
        # a second streaming pass; primaries of those qnames deport to the
        # PRIM component so DEPN can compress against them. Skipped when the
        # segconf sample shows DEPN qnames never reappear on primaries
        # (DEPN-only deportation needs no second read).
        try:
            r2 = TxtReader(in_path, truncate=truncate)
            dt.read_txt_header(r2)
            hs = [h for data in r2.vblocks(dt, vb_size)
                  for h in [dt.depn_qname_hashes(data)] if h.shape[0]]
            r2.close()
            if hs:
                depn_qnames = np.unique(np.concatenate(hs))
        except (OSError, ValueError):
            depn_qnames = None  # unseekable input: DEPN-only deportation
    sharded = None
    if dp:
        # VBs data-parallel over the 'dp' mesh axis: a batch of dp VBs'
        # payload sections ride one sharded device kernel; archive bytes
        # equal the host path's (parallel/zip_sharded.py)
        from .parallel.zip_sharded import ShardedZipEncoder
        sharded = ShardedZipEncoder(n_devices=dp)
    batch_built = []

    def flush_batch():
        if not batch_built:
            return
        items, keys = [], []
        for bi, b in enumerate(batch_built):
            for i, e in enumerate(b["pending"]):
                if e[3] in (codecs.RANS0, codecs.RANS1) and \
                        sharded.eligible(len(e[2])):
                    items.append((e[2], 0 if e[3] == codecs.RANS0 else 1))
                    keys.append((bi, i))
        with profiler.timer("zip:dp-encode"):
            blobs = sharded.encode_sections(items) if items else []
        pre = {}
        for (bi, i), blob in zip(keys, blobs):
            pre.setdefault(bi, {})[i] = blob
        for bi, b in enumerate(batch_built):
            job.flush_vb(b, pre.get(bi, {}))
        batch_built.clear()

    with ThreadPoolExecutor(max_workers=workers) as pool:
        def seg_one(data):
            with profiler.timer("zip:seg"):
                res = dt.seg_vb(data)
            with profiler.timer("zip:compress-local"):
                # local-section compression in the compute thread
                # (reference zip.c:566); VB 1 drains alone first, so the
                # codecs it commits are visible to every later VB
                pre = job.precompress_locals(res)
            return res, pre

        inflight = deque()  # (data, future, (prim pos, depn pos)) in VB order
        def submit(data):
            nonlocal file_adler
            # digests always cover the ORIGINAL stream, pre-deportation
            file_adler = zlib.adler32(data, file_adler)
            if md5:
                md5.update(data)
            gcpos = None
            if use_gencomp:
                gc = dt.gencomp_split(data, depn_qnames)
                if gc is not None:
                    data, pri, dep, ppos, dpos = gc
                    prim_parts.append(pri)
                    depn_parts.append(dep)
                    gcpos = (ppos, dpos)
            return (data, pool.submit(seg_one, data), gcpos)

        def drain(pending):
            nonlocal vb_i
            pdata, pfut, gcpos = pending
            vb_i += 1
            with profiler.timer("zip:seg-wait"):
                pres, pre_locals = pfut.result()
            if gcpos is not None:
                ppos, dpos = gcpos
                for nm, pos in (("GPPOS", ppos), ("GCPOS", dpos)):
                    if pos.shape[0]:
                        pres.ctxs[nm] = VBCtx(
                            nm, MODE_NUM,
                            local=np.diff(pos, prepend=np.int64(0)),
                            cat="int", param=1)
            with profiler.timer("zip:merge+write"):
                if sharded is None:
                    job.write_vb(pres, pdata, vb_i, 0,
                                 pre_locals=pre_locals)
                else:
                    batch_built.append(job.build_vb(pres, pdata, vb_i, 0))
                    if len(batch_built) >= sharded.D:
                        flush_batch()
            prog.update(int(pdata.shape[0]))

        for data in reader.vblocks(dt, vb_size):
            inflight.append(submit(data))
            # VB 1 segs alone: per-file lazy seg state (e.g. the QUAL demux
            # class) is decided by the first VB — the reference's first-sight
            # commit (codec.c:210) — before later VBs fan out concurrently
            if vb_i == 0:
                drain(inflight.popleft())
            elif len(inflight) > workers:
                drain(inflight.popleft())
        while inflight:
            drain(inflight.popleft())
        if sharded is not None:
            flush_batch()
    prog.finish()

    def _write_chunks(txt: np.ndarray, comp_i: int) -> int:
        gvb = 0
        off = 0
        while off < txt.shape[0]:
            end = min(off + vb_size, txt.shape[0])
            chunk = txt[off:off + int(dt.vb_boundary(txt[off:end], end == txt.shape[0]))] \
                if end < txt.shape[0] else txt[off:end]
            if chunk.shape[0] == 0:
                chunk = txt[off:end]
            gvb += 1
            job.write_vb(dt.seg_vb(chunk), chunk, gvb, comp_i)
            off += chunk.shape[0]
        return gvb

    gencomp_hdr = None
    if prim_parts or depn_parts:
        prim = np.concatenate(prim_parts) if prim_parts else np.zeros(0, np.uint8)
        depn = np.concatenate(depn_parts) if depn_parts else np.zeros(0, np.uint8)
        gp = _write_chunks(prim, 1)
        if prim.shape[0]:
            # SAG store: DEPN compresses against its primary (sam_sag_ingest.c)
            dt.sag_store = dt.build_sag_store(prim)
        gd = _write_chunks(depn, 2)
        dt.sag_store = None
        gencomp_hdr = {"prim_vbs": gp, "depn_vbs": gd}

    mgzip = None
    from .utils.bgzf import BgzfBlockReader, MgzipBlockReader
    if isinstance(reader.f, (BgzfBlockReader, MgzipBlockReader)):
        mgzip = reader.f.mgzip_info()
        if mgzip.get("exact"):
            isz = np.asarray(reader.f.isizes, dtype="<u4").tobytes()
            job.zw.write_section(fmt.SEC_GZ_ISIZES, isz, codec=codecs.RANS0
                                 if len(isz) >= 64 else codecs.NONE)

    ref_internal = _maybe_write_internal_ref(job, dt, reference)
    ref_stored = _maybe_write_stored_ref(job, dt, reference, store_ref)

    file_hdr = {
        "version": 2, "dt": dt_name, "num_vbs": vb_i,
        "num_lines": job.stats.num_lines, "txt_len": job.stats.txt_len,
        "adler": file_adler, "segconf": dt.segconf,
        "txt_name": in_path.rsplit("/", 1)[-1],
        "reference": reference.rsplit("/", 1)[-1] if reference else None,
        "ref_internal": ref_internal,
        "ref_stored": ref_stored,
        "enc": enc,
        "md5": md5.hexdigest() if md5 else None,
        "mgzip": mgzip,
        "gencomp": gencomp_hdr,
    }
    job.write_global_area(file_hdr)
    reader.close()
    if show_stats:
        print_stats(job.stats, job.gctxs)
    return job.stats


def zip_pair(in1: str, in2: str, out_path: str,
             vb_size: int | None = None, show_stats: bool = False,
             reference: str | None = None, threads: int | None = None,
             optimize: bool = False):
    """R1/R2 paired FASTQ co-compression into one two-component archive.
    Two-stage dispatcher (the zip_file fan-out applied to pairing): workers
    seg R1 VBs; the ordered drain reads the matching R2 reads and hands
    them to a second worker stage (seg R2 + pair-GPOS delta + local
    compression); the final ordered drain writes both components."""
    import copy as _copy
    import os as _os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    r1, dt1, _ = _open_component(in1, "fastq", reference)
    r2, dt2, _ = _open_component(in2, "fastq", reference)
    if vb_size is None:
        vb_size = dt1.suggested_vb_size() or DEFAULT_VB_SIZE
    dt1.optimize_enabled = dt2.optimize_enabled = optimize
    job = ZipJob(out_path)

    adler = [zlib.adler32(b""), zlib.adler32(b"")]
    nvbs = 0
    lines = [0, 0]
    tlens = [0, 0]
    workers = threads or min(max(_os.cpu_count() or 2, 1), 8)

    def seg1(data1):
        with profiler.timer("zip:seg"):
            res1 = dt1.seg_vb(data1)
        pre1 = job.precompress_locals(res1)
        return res1, pre1

    def seg2(data2, hint, first):
        # later VBs run on a shallow copy so the shared dt2's per-file
        # lazy state (qual class, segconf) is read, never raced; VB 1 runs
        # on the original (alone) and COMMITS that state
        d2 = dt2 if first else _copy.copy(dt2)
        d2.pair_gpos_hint = hint
        with profiler.timer("zip:seg"):
            res2 = d2.seg_vb(data2)
        # pair-assisted GPOS: R2 gpos as delta vs R1's (same read index,
        # reference fastq_seq.c:187); hint carries R1's per-read gpos
        if hint is not None and "GPOS" in res2.ctxs:
            a1 = hint >= 0
            a2 = res2.ctxs["SQBITMAP"].local.astype(bool)
            g1 = np.where(a1, hint, 0)
            both = a2 & a1
            g2 = res2.ctxs["GPOS"].local.copy()
            delta = g2 - g1[a2]
            res2.ctxs["GPOS"].local = np.where(both[a2], delta, g2)
            res2.ctxs["GPOS"].param = 0
            res2.meta["gpos_pair_delta"] = True
        pre2 = job.precompress_locals(res2)
        return res2, pre2

    def write_pair(vb_i, data1, res1, pre1, data2, res2, pre2):
        assert res2.num_lines == res1.num_lines, \
            f"R2 out of sync: {res2.num_lines} reads vs R1 {res1.num_lines}"
        with profiler.timer("zip:merge+write"):
            p1 = job.write_vb(res1, data1, vb_i, 0, collect=True,
                              pre_locals=pre1)
            job.write_vb(res2, data2, vb_i, 1, pair_payloads=p1,
                         pre_locals=pre2)
        adler[0] = zlib.adler32(data1, adler[0])
        adler[1] = zlib.adler32(data2, adler[1])
        tlens[0] += data1.shape[0]
        tlens[1] += data2.shape[0]
        lines[0] += res1.num_lines
        lines[1] += res2.num_lines

    with ThreadPoolExecutor(max_workers=workers) as pool:
        stage1 = deque()   # (data1, future(res1, pre1))
        stage2 = deque()   # (vb_i, data1, res1, pre1, data2, future2)

        def advance1():
            """Drain one R1 seg in order -> read R2 -> submit stage 2."""
            nonlocal nvbs
            data1, fut1 = stage1.popleft()
            res1, pre1 = fut1.result()
            nvbs += 1
            data2 = r2.read_fastq_records(res1.num_lines)
            if dt2.optimize_enabled:
                data2 = dt2.optimize_vb(data2)
            hint = None
            if "SQBITMAP" in res1.ctxs:
                hint = np.full(res1.num_lines, -1, np.int64)
                a1m = res1.ctxs["SQBITMAP"].local.astype(bool)
                hint[a1m] = res1.ctxs["GPOS"].local
            fut2 = pool.submit(seg2, data2, hint, nvbs == 1)
            stage2.append((nvbs, data1, res1, pre1, data2, fut2))

        def advance2():
            vb_i, data1, res1, pre1, data2, fut2 = stage2.popleft()
            res2, pre2 = fut2.result()
            write_pair(vb_i, data1, res1, pre1, data2, res2, pre2)

        first = True
        for data1 in r1.vblocks(dt1, vb_size):
            stage1.append((data1, pool.submit(seg1, data1)))
            if first:
                # VB 1 fully alone: codec commits + per-file lazy seg state
                advance1()
                advance2()
                first = False
                continue
            while len(stage1) > workers:
                advance1()
            while len(stage2) > workers:
                advance2()
        while stage1:
            advance1()
        while stage2:
            advance2()
    leftover = r2.read_fastq_records(1)
    assert leftover.shape[0] == 0, "R2 has more reads than R1"

    file_hdr = {
        "version": 2, "dt": "fastq", "num_vbs": nvbs,
        "num_lines": sum(lines), "txt_len": sum(tlens),
        "adler": None, "segconf": dt1.segconf,
        "txt_name": in1.rsplit("/", 1)[-1],
        "reference": reference.rsplit("/", 1)[-1] if reference else None,
        "pair": True,
        "components": [
            {"name": in1.rsplit("/", 1)[-1], "txt_len": tlens[0],
             "adler": adler[0], "num_lines": lines[0]},
            {"name": in2.rsplit("/", 1)[-1], "txt_len": tlens[1],
             "adler": adler[1], "num_lines": lines[1]},
        ],
    }
    job.write_global_area(file_hdr)
    r1.close()
    r2.close()
    if show_stats:
        print_stats(job.stats, job.gctxs)
    return job.stats


def _fanout_component(job, reader, dt, vb_size, comp_i, on_data=None,
                      workers=None, adler0=None):
    """zip_file's N-way seg fan-out with ordered drain for one archive
    component (dispatcher.c:544 analog). `on_data` runs in the ordered
    drain (e.g. deep-index ingestion, which is order-sensitive). Returns
    (txt_len, num_lines, adler, num_vbs); the running adler chains from
    `adler0` (e.g. the already-hashed txt header)."""
    import os as _os
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    workers = workers or min(max(_os.cpu_count() or 2, 1), 8)
    adler = zlib.adler32(b"") if adler0 is None else adler0
    vb_i = 0
    tlen = 0
    nlines = 0

    def seg_one(data):
        with profiler.timer("zip:seg"):
            res = dt.seg_vb(data)
        return res, job.precompress_locals(res)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        inflight = deque()

        def drain():
            nonlocal vb_i, adler, tlen, nlines
            data, fut = inflight.popleft()
            res, pre = fut.result()
            vb_i += 1
            adler = zlib.adler32(data, adler)
            if on_data is not None:
                on_data(data)
            with profiler.timer("zip:merge+write"):
                job.write_vb(res, data, vb_i, comp_i, pre_locals=pre)
            tlen += data.shape[0]
            nlines += res.num_lines

        for data in reader.vblocks(dt, vb_size):
            inflight.append((data, pool.submit(seg_one, data)))
            if vb_i == 0:
                drain()     # VB 1 alone: codec commits + lazy seg state
            elif len(inflight) > workers:
                drain()
        while inflight:
            drain()
    return tlen, nlines, adler, vb_i


def zip_deep(bam_path: str, fastq_paths: list[str], out_path: str,
             vb_size: int | None = None, show_stats: bool = False,
             reference: str | None = None):
    """Deep: BAM + FASTQ(s) into one archive; FASTQ reads matching BAM
    alignments store only hit flags (reference src/fastq_deep.c,
    src/sam_deep.c; genozip --deep)."""
    from .deep import DeepIndex

    job = ZipJob(out_path)
    index = DeepIndex()
    comps = []
    nvbs_max = 0

    # component 0: BAM (feeding the deep index IN VB ORDER from the drain)
    reader, dt, _ = _open_component(bam_path, "bam", None)
    if vb_size is None:
        vb_size = dt.suggested_vb_size() or DEFAULT_VB_SIZE
    bam_dt = dt
    hdr = dt.read_txt_header(reader)
    hadler = zlib.adler32(b"")
    if hdr:
        hadler = zlib.adler32(hdr, hadler)
        job.zw.write_section(fmt.SEC_TXT_HEADER, hdr,
                             codec=codec_assign.assign_best(hdr, "text"),
                             comp_i=0)
    tlen, nlines, adler, vb_i = _fanout_component(
        job, reader, dt, vb_size, 0,
        on_data=lambda d: index.add_bam_records(d.tobytes()),
        adler0=hadler)
    reader.close()
    comps.append({"name": bam_path.rsplit("/", 1)[-1], "dt": "bam",
                  "txt_len": tlen + len(hdr), "adler": adler,
                  "num_lines": nlines, "num_vbs": vb_i,
                  "segconf": dt.segconf})
    nvbs_max = max(nvbs_max, vb_i)

    for ci, fq in enumerate(fastq_paths, start=1):
        reader, dt, _ = _open_component(fq, "fastq", reference)
        dt.deep_index = index
        tlen, nlines, adler, vb_i = _fanout_component(
            job, reader, dt, vb_size, ci)
        reader.close()
        comps.append({"name": fq.rsplit("/", 1)[-1], "dt": "fastq",
                      "txt_len": tlen, "adler": adler, "num_lines": nlines,
                      "num_vbs": vb_i})
        nvbs_max = max(nvbs_max, vb_i)

    ref_internal = _maybe_write_internal_ref(job, bam_dt, None)
    file_hdr = {
        "version": 2, "dt": "bam", "num_vbs": nvbs_max,
        "num_lines": sum(c["num_lines"] for c in comps),
        "txt_len": sum(c["txt_len"] for c in comps),
        "adler": None, "segconf": {}, "deep": True,
        "ref_internal": ref_internal,
        "txt_name": bam_path.rsplit("/", 1)[-1],
        "reference": reference.rsplit("/", 1)[-1] if reference else None,
        "components": comps,
    }
    job.write_global_area(file_hdr)
    if show_stats:
        print_stats(job.stats, job.gctxs)
    return job.stats


def print_stats(stats: ZipStats, gctxs):
    dt_sec = time.time() - stats.start
    ratio = stats.txt_len / max(stats.z_len, 1)
    print(f"txt {stats.txt_len:,} -> z {stats.z_len:,}  ratio {ratio:.2f}x  "
          f"{stats.txt_len / 1e6 / max(dt_sec, 1e-9):.1f} MB/s  "
          f"vbs {stats.num_vbs} lines {stats.num_lines:,}")
    rows = sorted(stats.per_ctx.items(), key=lambda kv: -kv[1][1])
    for name, (u, z) in rows:
        print(f"  {name:12s} z {z:>12,}  ({100.0 * z / max(stats.z_len, 1):5.1f}%)")
