"""Point-stream binning: the device replacement for the reference's random
pixel writes (src/lib.rs:807-834).

The reference's hot loop does three random-access read-modify-writes per
iteration (count increment, z-test, steps/zbuf store) into >2-megapixel
CPU buffers — the access pattern it names as its own bottleneck
(src/lib.rs:31-35). On the device those become scatter updates applied
once per *chunk* of ``lanes x chunk_steps`` points:

- EXACT: scatter-add the counts, scatter-max the z-buffer, then recover the
  per-pixel winning value with a gather + masked scatter. Reference
  semantics up to measure-zero z ties.
- PACKED: (z, value) packed into one uint32 — 20 high bits are an
  order-preserving transform of the f32 depth offset so that the -1.0
  sentinel maps to 0, 12 low bits are the quantized palette position — so
  the whole z-test collapses into a single scatter-max and merging states is
  ``maximum``. ~2x less scatter traffic; depth resolution ~2^-11 relative,
  palette resolution 1/4096.

All functions operate on flattened (npix,) planes; ``flat`` indices equal to
``npix`` (out-of-bounds points) are dropped by the scatter, mirroring the
bounds-check ``continue`` at src/lib.rs:789-795.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp
from jax import lax

# Order-preserving uint32 image of f32(-1.0): bits(-1.0) = 0xBF80_0000 is
# negative, so mono = ~bits = 0x407F_FFFF.
# numpy scalars, NOT jnp: module-level jnp constants initialize the XLA
# backend at import, which breaks jax.distributed.initialize() (it must run
# before any backend touch — parallel/distributed.py).
_MONO_NEG1 = np.uint32(0x407FFFFF)
_VAL_BITS = 12
_VAL_SCALE = float(1 << _VAL_BITS)
_VAL_MASK = np.uint32((1 << _VAL_BITS) - 1)
_ZKEY_MASK = np.uint32(0xFFFFFFFF ^ ((1 << _VAL_BITS) - 1))


def _mono_u32(z):
    """Monotone f32 -> uint32 map: negative floats flip all bits, positive
    floats flip the sign bit. Preserves total order of non-NaN floats."""
    u = lax.bitcast_convert_type(z.astype(jnp.float32), jnp.uint32)
    neg = (u >> 31) == 1
    return jnp.where(neg, ~u, u | jnp.uint32(0x80000000))


def _inv_mono_u32(mono):
    neg = mono < jnp.uint32(0x80000000)
    bits = jnp.where(neg, ~mono, mono & jnp.uint32(0x7FFFFFFF))
    return lax.bitcast_convert_type(bits, jnp.float32)


def pack_zv(z, val):
    """Pack (depth, palette value) into uint32; 0 means 'unset or z <= -1'.

    Points at or below the z sentinel never win the z-test in the reference
    (zbuf starts at -1.0 and the test is strictly greater, src/lib.rs:818-821)
    so mapping them to 0 preserves semantics.
    """
    d = _mono_u32(z) - _MONO_NEG1
    q = jnp.clip(val, 0.0, 0.999999)
    q = (q * _VAL_SCALE).astype(jnp.uint32)
    packed = (d & _ZKEY_MASK) | q
    return jnp.where(z > -1.0, packed, jnp.uint32(0))


def unpack_zv(packed):
    """Decode a packed plane to (zbuf, steps) planes.

    Unset pixels decode to exactly (-1.0, 0.0) — the reference's reset values
    (src/lib.rs:688-693). Depth decodes to the lower edge of its 2^12-ulp
    bucket; the value to the lower edge of its 1/4096 bucket.
    """
    q = packed & _VAL_MASK
    val = q.astype(jnp.float32) / jnp.float32(_VAL_SCALE)
    mono = (packed & _ZKEY_MASK) + _MONO_NEG1
    z = _inv_mono_u32(mono)
    return z, val


def bin_chunk_exact(count, steps, zbuf, flat, z, val):
    """EXACT strategy: reference-faithful accumulation of one point chunk.

    ``count``/``steps``/``zbuf`` are flattened (npix,) planes (+1 is NOT
    needed: out-of-range ``flat == npix`` is dropped). ``flat``/``z``/``val``
    are flat point arrays. Returns updated planes.

    Tie semantics: the reference's strict ``z2 > zbuf`` test (src/lib.rs:821)
    keeps the *earlier* value on equal depths. Cross-chunk ties replicate
    that exactly (the pre-chunk z-buffer is gathered and must be strictly
    beaten). Equal-z duplicates *within* one chunk resolve nondeterministically
    (scatter ``.set`` picks one) — the single remaining measure-zero deviation.
    """
    npix = count.shape[0]
    count = count.at[flat].add(jnp.uint32(1), mode="drop")
    z = z.astype(jnp.float32)
    # pre-chunk depth: a chunk point tying it must NOT overwrite (strict >)
    zold = zbuf.at[flat].get(mode="fill", fill_value=float("inf"))
    zbuf = zbuf.at[flat].max(z, mode="drop")
    znew = zbuf.at[flat].get(mode="fill", fill_value=float("-inf"))
    # winner: reached its pixel's max depth, strictly beat the pre-chunk
    # value, and beat the -1.0 sentinel
    winner = (z >= znew) & (z > zold) & (z > -1.0)
    steps = steps.at[jnp.where(winner, flat, npix)].set(val.astype(jnp.float32), mode="drop")
    return count, steps, zbuf


def bin_chunk_packed(count, packed, flat, packed_update):
    """PACKED strategy: two scatters per chunk (add + max)."""
    count = count.at[flat].add(jnp.uint32(1), mode="drop")
    packed = packed.at[flat].max(packed_update, mode="drop")
    return count, packed


def bin_chunk_depth(zbuf, flat, z):
    """DEPTH strategy: a depth render needs only the exact f32 z-buffer
    (src/lib.rs:875-899 reads nothing else), so one scatter-max suffices."""
    return (zbuf.at[flat].max(z.astype(jnp.float32), mode="drop"),)
