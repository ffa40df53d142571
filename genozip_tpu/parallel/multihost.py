"""Multi-host (multi-process) ZIP: SPMD workers over jax.distributed.

Reference parity: the reference has NO multi-node story (SURVEY §2 note) —
this is the multi-host extension BASELINE.md asks for ("scaling
efficiency at N >= 2 hosts"). Design:

- N processes initialize `jax.distributed` (on one box it rides loopback
  TCP through the same collective machinery a cluster uses across hosts).
- Every rank reads the input stream and splits VBs identically
  (deterministic boundaries), then SEGS ONLY ITS STRIPE (vb_i round-robin)
  and precompresses locals — the compute-heavy phases run genuinely in
  parallel across processes.
- Cross-host collectives on the global mesh: a psum of per-rank
  (txt_bytes, lines, vbs) totals, and the dict-merge collective
  (parallel/zip_sharded.make_collective_merge) over per-rank novel-word
  hashes — asserted equal to the sequential host twin, the same
  determinism contract the single-process dp path guarantees.
- Rank 0 then drains in GLOBAL VB ORDER (dict merge order = archive
  determinism, context.c:938 analog), consuming the other ranks' seg
  results across the process boundary, and writes the archive — which is
  asserted byte-identical to the single-process `zip_file` archive.

Bulk seg results cross the boundary via a shared scratch directory (the
one-box dryrun transport); the merge DECISIONS and totals cross via the
jax.distributed collectives, which is what generalizes to real DCN.

The workers run on the CPU backend on purpose: they are several processes
on one box, and several JAX processes cannot share one GPU (each reserves
most of its memory at start-up).
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import zlib


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def zip_file_multihost(src: str, out: str, n_procs: int = 2,
                       vb_size: int | None = None,
                       devices_per_proc: int = 2,
                       timeout: int = 600) -> None:
    """Compress `src` with `n_procs` jax.distributed processes; the
    archive at `out` is byte-identical to single-process zip_file."""
    port = _free_port()
    scratch = tempfile.mkdtemp(prefix="gxz_mh_")
    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"       # one card cannot host N processes
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{devices_per_proc}")
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "genozip_tpu.parallel.multihost",
         str(rank), str(n_procs), f"localhost:{port}", src, out, scratch,
         str(vb_size or 0)], env=env)
        for rank in range(n_procs)]
    fails = []
    for rank, p in enumerate(procs):
        try:
            rc = p.wait(timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = -9
        if rc != 0:
            fails.append((rank, rc))
    assert not fails, f"multihost workers failed: {fails}"


def _worker(rank: int, nprocs: int, coord: str, src: str, out: str,
            scratch: str, vb_size: int) -> None:
    import jax
    jax.distributed.initialize(coord, num_processes=nprocs, process_id=rank)
    import numpy as np
    import jax.numpy as jnp
    from jax.experimental.multihost_utils import process_allgather
    from ..zip_pipeline import _open_component, ZipJob, DEFAULT_VB_SIZE
    from ..codecs import assign as codec_assign
    from ..format import sections as fmt
    from ..utils import profiler
    from .. import sag as sag_mod
    from ..utils.ragged import Col

    reader, dt, dt_name = _open_component(src, None, None)
    assert not reader.is_compressed, "multihost v1 takes plain inputs"
    if not vb_size:
        vb_size = dt.suggested_vb_size() or DEFAULT_VB_SIZE
    my_out = out if rank == 0 else os.path.join(scratch, f"r{rank}.gxz")
    job = ZipJob(my_out)

    # identical on every rank: header, calibration commits, freeze
    txt_header = dt.read_txt_header(reader)
    file_adler = zlib.adler32(b"")
    if txt_header:
        file_adler = zlib.adler32(txt_header, file_adler)
        codec = codec_assign.assign_best(txt_header, "text")
        if rank == 0:
            job.zw.write_section(fmt.SEC_TXT_HEADER, txt_header,
                                 codec=codec, comp_i=0)
            job.stats.txt_len += len(txt_header)
    cal = reader.peek(1 << 20)
    if cal:
        cdata = np.frombuffer(cal, np.uint8)
        cut = dt.vb_boundary(cdata, False)
        if 0 < cut:
            try:
                cres = dt.seg_vb(cdata[:cut].copy())
                job.precommit_codecs(cres)
            except Exception:
                pass
    dt.freeze_lazy_choices()

    # phase A: seg MY stripe; collect per-VB novel-word hashes of the
    # largest dict context for the cross-host merge collective
    vb_i = 0
    my_txt = 0
    my_lines = 0
    dict_hashes = []
    for data in reader.vblocks(dt, vb_size):
        vb_i += 1
        file_adler = zlib.adler32(data, file_adler)
        if (vb_i - 1) % nprocs != rank:
            continue
        with profiler.timer("mh:seg"):
            res = dt.seg_vb(data)
        pre = job.precompress_locals(res)
        tmp = os.path.join(scratch, f"vb{vb_i}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump((res, pre), f, protocol=4)
        os.replace(tmp, os.path.join(scratch, f"vb{vb_i}.pkl"))
        my_txt += int(data.shape[0])
        my_lines += res.num_lines
        big = max((c for c in res.ctxs.values() if c.vb_words is not None),
                  key=lambda c: len(c.vb_words), default=None)
        if big is not None:
            dict_hashes.append(sag_mod.qname_hash(big.vb_words))
    reader.close()
    n_vbs = vb_i

    # cross-host collectives (the DCN phase): totals psum + the dict-merge
    # collective over per-rank novel-word hashes, checked against the
    # sequential host twin on every rank
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()), ("dp",))
    totals = process_allgather(
        jnp.asarray(np.asarray([my_txt, my_lines], np.float64)))
    totals = np.asarray(totals).reshape(nprocs, 2).sum(axis=0)
    W = 256
    mine = (np.concatenate(dict_hashes)[:W] if dict_hashes
            else np.zeros(0, np.uint64))
    padded = np.zeros(W, np.uint64)
    padded[:mine.shape[0]] = mine
    valid_row = np.zeros(W, bool)
    valid_row[:mine.shape[0]] = True
    # 32-bit halves: uint64 needs jax x64 which stays off
    g_hi = np.asarray(process_allgather(jnp.asarray(
        (padded >> np.uint64(32)).astype(np.uint32)))).reshape(nprocs, W)
    g_lo = np.asarray(process_allgather(jnp.asarray(
        (padded & np.uint64(0xFFFFFFFF)).astype(np.uint32)))).reshape(
            nprocs, W)
    gh = (g_hi.astype(np.uint64) << np.uint64(32)) | g_lo.astype(np.uint64)
    gv = np.asarray(process_allgather(
        jnp.asarray(valid_row))).reshape(nprocs, W)
    from . import zip_sharded
    if len(jax.devices()) >= nprocs:
        # the collective-merge kernel over the GLOBAL mesh: each process
        # feeds its local shard; result must equal the sequential merge
        sh = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("dp"))
        D = len(jax.devices())
        per = D // nprocs
        hh = np.repeat(gh, per, axis=0)[: D]
        vvv = np.repeat(gv, per, axis=0)[: D]
        local_h = hh[rank * per:(rank + 1) * per]
        local_v = vvv[rank * per:(rank + 1) * per]
        hi = jax.make_array_from_process_local_data(
            sh, (local_h >> np.uint64(32)).astype(np.uint32))
        lo = jax.make_array_from_process_local_data(
            sh, (local_h & np.uint64(0xFFFFFFFF)).astype(np.uint32))
        vv = jax.make_array_from_process_local_data(sh, local_v)
        merge = zip_sharded.make_collective_merge(mesh, W)
        lut, nuniq = merge(hi, lo, vv)
        ref_lut, nref = zip_sharded.collective_merge_host_twin(hh, vvv)
        assert (np.asarray(lut) == ref_lut).all() and int(nuniq) == nref, \
            "cross-host collective dict merge != host twin"

    # phase C: rank 0 drains in GLOBAL VB order across the process
    # boundary and writes the archive
    if rank == 0:
        r2, dt2, _ = _open_component(src, dt_name, None)
        dt2.segconf = dt.segconf
        dt2.read_txt_header(r2)
        if cal:
            # replicate phase A's calibration peek: vblocks takes the whole
            # buffered prefix as VB 1, so the peek sequence IS part of the
            # VB boundary layout and must match exactly
            r2.peek(1 << 20)
        vb_j = 0
        for data in r2.vblocks(dt, vb_size):
            vb_j += 1
            pkl = os.path.join(scratch, f"vb{vb_j}.pkl")
            with open(pkl, "rb") as f:
                res, pre = pickle.load(f)
            with profiler.timer("mh:merge+write"):
                job.write_vb(res, data, vb_j, 0, pre_locals=pre)
        r2.close()
        assert vb_j == n_vbs
        file_hdr = {
            "version": 2, "dt": dt_name, "num_vbs": vb_j,
            "num_lines": job.stats.num_lines, "txt_len": job.stats.txt_len,
            "adler": file_adler, "segconf": dt.segconf,
            "txt_name": src.rsplit("/", 1)[-1],
            "reference": None,
            "ref_internal": False,
            "ref_stored": False,
            "enc": None,
            "md5": None,
            "mgzip": None,
            "gencomp": None,
        }
        job.write_global_area(file_hdr)
    # final barrier so the coordinator (rank 0's distributed service) stays
    # up until the archive is written, then clean shutdown everywhere
    process_allgather(jnp.zeros(1))
    jax.distributed.shutdown()


if __name__ == "__main__":
    _rank, _n, _coord, _src, _out, _scratch, _vb = sys.argv[1:8]
    _worker(int(_rank), int(_n), _coord, _src, _out, _scratch, int(_vb))
