"""The batched device rANS coder (ops/rans_gpu.py) and how the pipelines
select it. On the CPU the Pallas kernels run in interpret mode, against the
numpy spec (ops/rans_np.py); `gpu`-marked tests run the compiled kernels
and skip where there is no card."""

import functools
import os
import types

import numpy as np
import pytest

from genozip_tpu import codecs, native
from genozip_tpu.ops import rans_gpu, rans_jax, rans_np

QUAL = np.frombuffer(b"#,:F", np.uint8)


def _payload(n, alphabet="qual", seed=0):
    rng = np.random.default_rng(seed)
    if alphabet == "qual":
        return QUAL[np.minimum(rng.geometric(0.5, n) - 1, 3)].tobytes()
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


# lane counts: the format's ends (16, 8192), choose_num_lanes' steps at the
# device threshold (256 KiB -> 1024) and at 1 MiB (-> 8192), and 256
LANES = [16, 256, 1024, 8192]


def _sizes(N):
    return [0, N // 2 + 1, 3 * N + 5]      # empty, n < N, n % N != 0


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("N", LANES)
@pytest.mark.parametrize("which", ["empty", "short", "ragged"])
def test_kernel_encode_matches_spec(order, N, which):
    n = _sizes(N)[["empty", "short", "ragged"].index(which)]
    data = _payload(n, "all", seed=N + n)
    got = rans_gpu.encode_many([(data, order)], n_lanes=N, interpret=True)
    assert got == [rans_np.encode(data, order=order, n_lanes=N)]


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("N", LANES)
@pytest.mark.parametrize("which", ["empty", "short", "ragged"])
def test_kernel_decode_matches_spec(order, N, which):
    n = _sizes(N)[["empty", "short", "ragged"].index(which)]
    data = _payload(n, "qual", seed=N + n)
    blob = rans_np.encode(data, order=order, n_lanes=N)
    assert rans_gpu.decode_many([blob], interpret=True) == [data]


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("n", [256 << 10, (1 << 20) - 1, 1 << 20])
def test_device_stream_equals_native(order, n):
    """Above the device threshold the device stream is the host stream:
    same choose_num_lanes width (1024, 4096, 8192 here), same bytes."""
    data = _payload(n, "qual", seed=n)
    got = rans_gpu.encode_many([(data, order)], interpret=True)[0]
    ref = native.rans_encode(data, order) if native.available() \
        else rans_np.encode(data, order=order)
    assert got == ref
    assert got[0] == rans_np.choose_num_lanes(n).bit_length() - 1


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("n", [0, 1, 4097, 70001, 1 << 20])
def test_rans_jax_gathers_match_spec(order, n):
    data = _payload(n, "all" if n % 2 else "qual", seed=n)
    blob = rans_np.encode(data, order=order)
    assert rans_jax.encode(data, order=order) == blob
    assert rans_jax.decode(blob) == data


def test_batch_sorts_pads_and_mixes_orders(monkeypatch):
    """Mixed orders and lane counts in one call; several launches per group
    (capped batch); results come back in the caller's order."""
    monkeypatch.setattr(rans_gpu, "_MAX_BATCH", 2)
    sizes = [300, 5000, 40, 5000, 17, 2600, 9000]
    items = [(_payload(n, "all" if i % 3 else "qual", seed=i), i % 2)
             for i, n in enumerate(sizes)]
    launches = list(rans_gpu._batches(
        [(rans_np.choose_num_lanes(len(d)), o) for d, o in items],
        [len(d) for d, _ in items]))
    for _, idxs in launches:
        assert len(idxs) <= 2
        assert [len(items[i][0]) for i in idxs] == \
            sorted((len(items[i][0]) for i in idxs), reverse=True)
    assert sorted(i for _, idxs in launches for i in idxs) == \
        list(range(len(items)))
    blobs = rans_gpu.encode_many(items, interpret=True)
    assert blobs == [rans_np.encode(d, order=o) for d, o in items]
    assert rans_gpu.decode_many(blobs, interpret=True) == \
        [d for d, _ in items]


@pytest.mark.parametrize("n,expect", [(0, 4096), (4096, 4096),
                                      (4097, 6144), (6145, 8192),
                                      (1 << 20, 1 << 20),
                                      ((1 << 20) + 1, 3 << 19)])
def test_shape_buckets(n, expect):
    assert rans_jax.bucket(n) == expect


@pytest.mark.parametrize("count,rows", [(1, 1), (2, 2), (3, 4), (9, 16)])
def test_launch_rows_pad_to_power_of_two(count, rows):
    assert rans_gpu._rows(count) == rows


def test_counts_track_sections_and_bytes():
    rans_gpu.counts.clear()
    data = _payload(3000, "qual")
    blob = rans_gpu.encode_many([(data, 0)], interpret=True)[0]
    rans_gpu.decode_many([blob, blob], interpret=True)
    assert rans_gpu.counts == {"encode_launches": 1, "encode_sections": 1,
                               "encode_bytes": 3000, "decode_launches": 1,
                               "decode_sections": 2, "decode_bytes": 6000}


def _fastq(path, reads=3000, seed=9):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(reads):
        s = rng.choice(np.frombuffer(b"ACGT", np.uint8), 150).tobytes()
        q = QUAL[np.minimum(rng.geometric(0.6, 150) - 1, 3)].tobytes()
        rows.append(b"@r%d\n%s\n+\n%s\n" % (i, s, q))
    data = b"".join(rows)
    open(path, "wb").write(data)
    return data


def test_selection_is_off_on_cpu(tmp_path):
    """CPU backend: no device coder (and so no interpret mode on the main
    path); ZIP and PIZ run the host coder."""
    from genozip_tpu.zip_pipeline import ZipJob
    from genozip_tpu.piz_pipeline import PizReader
    from genozip_tpu.zip_pipeline import zip_file
    assert codecs.device_coder() is None
    src = str(tmp_path / "a.fastq")
    _fastq(src, reads=50)
    zip_file(src, src + ".gxz")
    job = ZipJob(str(tmp_path / "b.gxz"))
    job.out.close()
    assert job.device is None
    pr = PizReader(src + ".gxz")
    assert pr.device is None
    pr.close()


def test_pipeline_device_archive_equals_host(tmp_path, monkeypatch):
    """The device coder, forced here in interpret mode with a small
    threshold, writes the same archive bytes as the host coder, and PIZ
    decodes it on the device coder back to the input."""
    from genozip_tpu.zip_pipeline import zip_file
    from genozip_tpu.piz_pipeline import piz_file
    src = str(tmp_path / "d.fastq")
    data = _fastq(src)
    zip_file(src, src + ".host.gxz", vb_size=256 << 10)
    interp = types.SimpleNamespace(
        encode_many=functools.partial(rans_gpu.encode_many, interpret=True),
        decode_many=functools.partial(rans_gpu.decode_many, interpret=True))
    monkeypatch.setattr(codecs, "device_coder", lambda: interp)
    monkeypatch.setattr(codecs, "DEVICE_MIN", 16 << 10)
    rans_gpu.counts.clear()
    zip_file(src, src + ".dev.gxz", vb_size=256 << 10)
    assert rans_gpu.counts["encode_sections"] > 0
    assert open(src + ".dev.gxz", "rb").read() == \
        open(src + ".host.gxz", "rb").read()
    piz_file(src + ".dev.gxz", src + ".out")
    assert rans_gpu.counts["decode_sections"] > 0
    assert open(src + ".out", "rb").read() == data


def test_dp_beyond_device_count_raises(tmp_path):
    import jax
    from genozip_tpu.zip_pipeline import zip_file
    src = str(tmp_path / "e.fastq")
    _fastq(src, reads=20)
    with pytest.raises(ValueError, match="--dp"):
        zip_file(src, src + ".gxz", dp=len(jax.devices()) + 1)


def test_mesh_beyond_device_count_raises():
    import jax
    from genozip_tpu.parallel.mesh_aligner import MeshAligner
    with pytest.raises(ValueError, match="--mesh"):
        MeshAligner(None, n_devices=len(jax.devices()) + 1)


def test_compile_cache_path(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise one fixed path
    in the checkout."""
    import jax
    from genozip_tpu import setup_compile_cache
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    setup_compile_cache()
    assert seen == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    setup_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert seen == [("jax_compilation_cache_dir",
                     os.path.join(root, ".jax_cache"))]


def test_native_reports_its_build():
    if not native.available():
        pytest.skip("native runtime unavailable")
    assert native.simd_bits() in (0, 512)
    assert native.has_libdeflate() in (True, False)


# --------------------------------------------------------------------------
# compiled kernels on the card
# --------------------------------------------------------------------------

@pytest.fixture
def gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")


@pytest.mark.gpu
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("n", [256 << 10, 300 << 10, 700 << 10, 1 << 20])
def test_gpu_kernels_match_spec(gpu, order, n):
    items = [(_payload(n, a, seed=n), order) for a in ("qual", "all")]
    blobs = rans_gpu.encode_many(items)
    assert blobs == [rans_np.encode(d, order=order) for d, _ in items]
    assert rans_gpu.decode_many(blobs) == [d for d, _ in items]


@pytest.mark.gpu
def test_gpu_pipeline_archive_equals_host(gpu, tmp_path, monkeypatch):
    from genozip_tpu.zip_pipeline import zip_file
    from genozip_tpu.piz_pipeline import piz_file
    src = str(tmp_path / "g.fastq")
    data = _fastq(src, reads=20000)
    rans_gpu.counts.clear()
    zip_file(src, src + ".dev.gxz")
    assert rans_gpu.counts["encode_sections"] > 0
    piz_file(src + ".dev.gxz", src + ".out")
    assert rans_gpu.counts["decode_sections"] > 0
    assert open(src + ".out", "rb").read() == data
    monkeypatch.setattr(codecs, "device_coder", lambda: None)
    zip_file(src, src + ".host.gxz")
    assert open(src + ".dev.gxz", "rb").read() == \
        open(src + ".host.gxz", "rb").read()
