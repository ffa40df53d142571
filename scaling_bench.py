#!/usr/bin/env python
"""Multi-device scaling harness: runs the sharded VB-encode step and the
2D-sharded aligner on growing meshes and reports MB/s + scaling efficiency.

Runs on the devices present (e.g. four GPUs: interconnect scaling);
`--virtual` gives the CPU rehearsal on 8 virtual devices — the collectives
are real, the absolute numbers are not. Prints one JSON line per mesh size,
naming the device it ran on.
"""

import json
import os
import sys
import time

if "--virtual" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def bench_encode(n_devices: int, reads=8192, read_len=256, iters=5):
    from genozip_tpu.parallel.flagship import (
        make_mesh, make_sharded_step, example_batch)
    mesh = make_mesh(n_devices)
    step = make_sharded_step(mesh)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    reads = reads // dp * dp
    read_len = read_len // sp * sp
    seq, qual, _, _ = example_batch(reads=reads, read_len=read_len)
    xs = jax.device_put(jnp.asarray(seq), NamedSharding(mesh, P("dp", "sp")))
    xq = jax.device_put(jnp.asarray(qual), NamedSharding(mesh, P("dp", "sp")))
    jax.block_until_ready(step(xs, xq))  # compile
    # best-of-iters: the bench host carries external load (~1 core), so a
    # mean is noise-dominated — the min is the honest machine number
    dt = None
    for _ in range(iters):
        t0 = time.time()
        jax.block_until_ready(step(xs, xq))
        d = time.time() - t0
        dt = d if dt is None else min(dt, d)
    mb = reads * read_len * 2 / 1e6  # seq + qual bytes
    return mb / dt


def bench_encode_weak(n_devices: int, reads_per_dev=4096, read_len=128,
                      iters=3):
    """WEAK scaling: fixed per-device load (total work grows with the
    mesh). Strong scaling of a fixed tiny batch measures dispatch
    overhead, not the machine — weak efficiency is what transfers to
    hardware."""
    return bench_encode(n_devices, reads=reads_per_dev * n_devices,
                        read_len=read_len, iters=iters)


def main():
    devs = len(jax.devices())
    dev = jax.devices()[0]
    sizes = [n for n in (1, 2, 4, 8) if n <= devs]
    base = None
    for n in sizes:
        mbps = bench_encode_weak(n)
        if base is None:
            base = mbps
        eff = mbps / (base * n)
        print(json.dumps({"devices": n, "platform": dev.platform,
                          "kind": dev.device_kind,
                          "encode_MBps": round(mbps, 1),
                          "weak_scaling_eff": round(eff, 3)}))


if __name__ == "__main__":
    main()
