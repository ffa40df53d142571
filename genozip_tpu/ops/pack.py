"""Bit packing ops (1/2/4-bit) — numpy host model + jnp device versions.

Vectorized replacement for the reference's Bits 2-bit arrays and htscodecs PACK
transform (reference src/bits.c, src/htscodecs/rANS_static4x16pr.c PACK):
values are packed little-endian within each byte (value i occupies bits
[(i*w) % 8, (i*w) % 8 + w) of byte (i*w)//8).
"""

import numpy as np
import jax.numpy as jnp

ACGT = np.frombuffer(b"ACGT", np.uint8)
# base -> 2-bit code; non-ACGT maps to 0 (exception channel carries the truth)
BASE2BIT = np.zeros(256, dtype=np.uint8)
BASE2BIT[ord("C")] = 1
BASE2BIT[ord("G")] = 2
BASE2BIT[ord("T")] = 3
IS_ACGT = np.zeros(256, dtype=bool)
IS_ACGT[ACGT] = True


def pack_np(vals: np.ndarray, width: int) -> np.ndarray:
    """Pack uint8 values < 2**width into bytes, little-endian bit order."""
    assert width in (1, 2, 4)
    per = 8 // width
    n = vals.shape[0]
    pad = (-n) % per
    if pad:
        vals = np.concatenate([vals, np.zeros(pad, np.uint8)])
    v = vals.reshape(-1, per)
    out = v[:, 0].copy()
    for i in range(1, per):                      # in-place OR: no uint16 temp
        out |= v[:, i] << np.uint8(i * width)
    return out


def unpack_np(packed: np.ndarray, width: int, n: int) -> np.ndarray:
    per = 8 // width
    mask = np.uint8((1 << width) - 1)
    out = np.empty((packed.shape[0], per), np.uint8)
    for i in range(per):
        np.right_shift(packed, np.uint8(i * width), out=out[:, i])
    out &= mask
    return out.reshape(-1)[:n]


def pack_jnp(vals, width: int):
    per = 8 // width
    n = vals.shape[0]
    pad = (-n) % per
    v = jnp.concatenate([vals, jnp.zeros(pad, jnp.uint8)]).reshape(-1, per)
    shifts = jnp.arange(per, dtype=jnp.uint8) * width
    return jnp.sum((v << shifts).astype(jnp.uint16), axis=1).astype(jnp.uint8)


def unpack_jnp(packed, width: int, n: int):
    per = 8 // width
    shifts = jnp.arange(per, dtype=jnp.uint8) * width
    mask = (1 << width) - 1
    v = (packed[:, None] >> shifts[None, :]) & mask
    return v.reshape(-1)[:n].astype(jnp.uint8)


def seq_pack_2bit(seq: np.ndarray):
    """DNA sequence -> (packed 2-bit codes, exception positions, exception bytes).
    Reference parity: src/codec_acgt.c (ACGT + NONREF_X exception channel)."""
    codes = BASE2BIT[seq]
    exc_mask = ~IS_ACGT[seq]
    exc_pos = np.nonzero(exc_mask)[0].astype(np.uint32)
    exc_bytes = seq[exc_mask]
    return pack_np(codes, 2), exc_pos, exc_bytes


def seq_unpack_2bit(packed: np.ndarray, n: int, exc_pos: np.ndarray, exc_bytes: np.ndarray):
    codes = unpack_np(packed, 2, n)
    seq = ACGT[codes]
    if exc_pos.shape[0]:
        seq[exc_pos] = exc_bytes
    return seq
