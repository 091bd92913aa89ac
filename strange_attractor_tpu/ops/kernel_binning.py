"""Sort-bin canvas accumulation (the ``*_KERNEL`` bin strategies).

The reference's hot loop does per-point random-access writes into megapixel
buffers and names that as its own bottleneck (src/lib.rs:31-35). The
scatter strategies (ops/binning.py) apply one update per point. The
sort-bin strategies first sort each chunk of emitted points by pixel, so
that a pixel's points form one contiguous run, and then touch every pixel
once per run:

1. **Pair sort**: the chunk is split into sections of ``section`` points
   and each section is sorted with ``lax.sort`` on (flat pixel, payload).
   Out-of-bounds points carry ``flat == npix`` and sort to the back.
2. **Winner marks**: comparing neighbouring sorted pixel keys marks each
   run's first and last element. A run's count is its length; its winner is
   the last element where the payload is a max key (KERNEL, DEPTH_KERNEL),
   and the first where the payload sorts the nearest z first (EXACT_KERNEL,
   EXACT16_KERNEL).
3. **Planes**: scatters that touch only the marked elements fold the runs
   into the planes. Counts and max keys fold straight into the persistent
   planes (add / max commute). The strict-z tiers fold sections in emission
   order into per-chunk delta planes, then into the persistent planes with
   the reference's strict ``z2 > zbuf`` test.

Three winner disciplines share the machinery:

- **KERNEL** (PACKED semantics): sections sorted by (flat, packed)
  ascending; each run's *last* element holds the max packed value. Planes
  are bit-identical to :func:`ops.binning.bin_chunk_packed`.
- **EXACT_KERNEL** (reference-faithful semantics): sections stably sorted
  by (flat, ~mono(z)) — z *descending*, emission order kept among exact
  (flat, z) ties — so each run's *first* element is the strict-greater-z
  winner with earliest-wins ties, exactly the reference's ``z2 > zbuf``
  test (src/lib.rs:818-833), including equal-z duplicates within one chunk
  (which the XLA scatter path resolves nondeterministically). Across
  sections a strictly smaller z key wins, so earlier sections keep ties.
- **EXACT16_KERNEL**: EXACT_KERNEL's z-test discipline at 16-bit z-bucket
  granularity with the winner payload packed into ONE u32 (bucket key |
  f16 value); precision contract in :func:`bin_chunk_kernel_exact16`.
- **DEPTH_KERNEL**: KERNEL's machinery with the monotone-u32 image of z as
  the max key.

Counts count every point, winners or not — matching the reference's
unconditional ``count[i,j] += 1`` (src/lib.rs:807-816). Out-of-bounds
points are dropped by every scatter — the vectorized bounds-check
``continue`` (src/lib.rs:789-795).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from .binning import _inv_mono_u32, _mono_u32

# Default points per sorted section, measured on the H100 (PERF.md, PR 1):
# the max-key tiers fold every section in one scatter, so shorter sorts win
# down to 2^13; the strict-z tiers fold sections one scan step at a time,
# which costs more than the shorter sorts save below 2^17.
MAX_KEY_SECTION = 1 << 13
STRICT_SECTION = 1 << 17


def _round_pow2(n: int) -> int:
    """Largest power of two <= n (1 for n < 1)."""
    return 1 << max(0, n.bit_length() - 1)


def _pad_sections(npix, flat, payloads, section, pad_values):
    """Pad the chunk to whole sections (pad points are out of bounds) and
    reshape every array to (S, sec). Sections are powers of two so that the
    earliest-ties u64 key can hold a within-section emission index."""
    m = flat.size
    sec = min(section, _round_pow2(m))
    pad = (-m) % sec
    arrays = [flat.astype(jnp.uint32), *payloads]
    if pad:
        arrays = [
            jnp.concatenate([a, jnp.full((pad,), v, a.dtype)])
            for a, v in zip(arrays, [npix, *pad_values])
        ]
    S = arrays[0].size // sec
    return [a.reshape(S, sec) for a in arrays]


def _sections(npix, flat, payloads, section, pad_values, *, stable=True):
    """Pad + section-reshape + per-section sort (keys: flat and the first
    payload; remaining payloads ride along).

    ``stable=False`` is valid whenever every operand is a key (equal-key
    elements are then interchangeable). EXACT_KERNEL must stay stable: its
    earliest-wins z-tie rule rides on emission order among (flat, z) ties
    (src/lib.rs:818-833)."""
    arrays = _pad_sections(npix, flat, payloads, section, pad_values)
    return list(lax.sort(tuple(arrays), dimension=1, num_keys=2, is_stable=stable))


def _runs(fs, npix):
    """Run marks of sorted (S, sec) pixel keys: ``(first, last, length)``.

    ``first``/``last`` mark each in-bounds pixel run's first and last
    element within its section; ``length`` holds, at every element, its
    1-based position in its run (so the run length at ``last``)."""
    S, sec = fs.shape
    differs = fs[:, 1:] != fs[:, :-1]
    edge = jnp.ones((S, 1), bool)
    live = fs < jnp.uint32(npix)
    first = jnp.concatenate([edge, differs], axis=1)
    last = jnp.concatenate([differs, edge], axis=1)
    pos = lax.broadcasted_iota(jnp.int32, (S, sec), 1)
    start = lax.cummax(jnp.where(first, pos, 0), axis=1)
    return first & live, last & live, pos - start + 1


def _at(npix, fs, mark):
    """Flat scatter indices of the marked elements; ``npix`` (dropped by
    ``mode="drop"``) elsewhere."""
    return jnp.where(mark, fs, jnp.uint32(npix)).astype(jnp.int32).reshape(-1)


def _add_counts(count, npix, fs, last, length):
    """Every run adds its length to its pixel's count."""
    return count.at[_at(npix, fs, last)].add(
        length.astype(jnp.uint32).reshape(-1), mode="drop")


def _strict_less(new, old):
    """Full-key z rule of the strict tiers: a smaller nonzero key (nearer
    z) replaces the standing entry; 0 means empty, and equal keys keep the
    standing (earlier) winner — the reference's ``z2 > zbuf``."""
    return (new != 0) & ((old == 0) | (new < old))


def _strict_less_bucket(new, old):
    """:func:`_strict_less` on the high 16-bit z-bucket key only (EXACT16
    earliest ties): a bucket tie keeps the earlier winner."""
    return (new != 0) & ((old == 0) | ((new >> 16) < (old >> 16)))


def _fold_sections(npix, fs, first, payloads, take):
    """Fold each section's run winners into zeroed per-chunk delta planes,
    section by section in emission order.

    Within a section every pixel has at most one winner, so the gather of
    the standing delta key and the set that replaces it touch each pixel
    once. ``take(new_key, old_key)`` decides on the first payload, which is
    the key; the others ride along."""

    def step(planes, xs):
        f, mark, *vals = xs
        idx = _at(npix, f, mark)
        old = planes[0].at[idx].get(mode="fill", fill_value=0)
        idx = jnp.where(take(vals[0], old), idx, npix)
        return tuple(p.at[idx].set(v, mode="drop") for p, v in zip(planes, vals)), None

    init = tuple(jnp.zeros((npix,), p.dtype) for p in payloads)
    planes, _ = lax.scan(step, init, (fs, first, *payloads))
    return planes


def _flood_gated(flat, evicted, plain, flood_gate):
    """Run ``evicted`` on chunks flooded at pixel 0 and ``plain`` otherwise.

    The reference's NaN quirk bins every remaining iteration of an escaped
    orbit at pixel (0,0) (src/lib.rs:789-812): on a long solar-sail render
    that is 35-40% of all points, all in one run. Pixel 0's update is a
    commutative (count += n, max) that two reductions compute directly, so
    ``evicted`` remaps those points out of bounds before the sort. The
    gate (> 1/64 of the chunk at pixel 0) keeps quiet chunks on the plain
    pipeline. Bit-exact either way, for any pixel-0 point, flood or not.

    ``flood_gate=False`` evicts unconditionally (still bit-exact): under
    ``vmap`` (the batched sequence paths) a data-dependent ``lax.cond``
    lowers to ``select_n`` and executes BOTH pipelines, so vmapped callers
    pick one branch statically.
    """
    if not flood_gate:
        return evicted(None)
    n0 = jnp.sum(flat == 0, dtype=jnp.uint32)
    return lax.cond(n0 > jnp.uint32(max(1, flat.size // 64)), evicted, plain, None)


@functools.partial(jax.jit, static_argnames=("npix", "section", "flood_gate"))
def bin_chunk_kernel(count, packed, flat, packed_update, *, npix: int,
                     section: int = MAX_KEY_SECTION, flood_gate: bool = True):
    """PACKED-semantics accumulation of one point chunk (KERNEL strategy).

    ``count``/``packed`` are the standard flattened (npix,) planes. ``flat``
    is int32 with ``npix`` marking out-of-bounds points; ``packed_update``
    is the uint32 packing of :func:`ops.binning.pack_zv`. Returns updated
    (count, packed) — bit-identical to :func:`ops.binning.bin_chunk_packed`.
    Pixel-0 floods are evicted before the sort (:func:`_flood_gated`).
    """
    is0 = flat == 0

    def run(f):
        # both operands are keys: an unstable sort is semantics-free
        fs, ps = _sections(npix, f, [packed_update], section, [0], stable=False)
        _, last, length = _runs(fs, npix)
        return (_add_counts(count, npix, fs, last, length),
                packed.at[_at(npix, fs, last)].max(ps.reshape(-1), mode="drop"))

    def evicted(_):
        p0 = jnp.max(jnp.where(is0, packed_update, jnp.uint32(0)))
        c, p = run(jnp.where(is0, jnp.int32(npix), flat))
        return c.at[0].add(jnp.sum(is0, dtype=jnp.uint32)), p.at[0].max(p0)

    return _flood_gated(flat, evicted, lambda _: run(flat), flood_gate)


@functools.partial(jax.jit, static_argnames=("npix", "section"))
def bin_chunk_kernel_exact(count, steps, zbuf, flat, z, val, *, npix: int,
                           section: int = STRICT_SECTION):
    """Reference-faithful accumulation (EXACT_KERNEL strategy).

    Same planes/semantics as :func:`ops.binning.bin_chunk_exact` — full f32
    ``steps``/``zbuf``, strict ``z2 > zbuf`` with earlier-wins ties — and
    deterministic for equal-(pixel, z) duplicates within one chunk where
    the scatter path is not (stable sort keeps emission order).
    """
    # descending-z ascending key; NaN z arrives as -inf (step fn), whose key
    # is huge but nonzero — only "no winner" encodes as 0. Canonicalize
    # -0.0 -> +0.0 first: the monotone map orders them as distinct keys but
    # the reference's float compare ties them (strict > keeps the earlier
    # point).
    z = jnp.where(z == 0.0, jnp.float32(0.0), z)
    zdesc = ~_mono_u32(z)
    valbits = lax.bitcast_convert_type(val.astype(jnp.float32), jnp.uint32)
    fs, zs, vs = _sections(npix, flat, [zdesc, valbits], section, [0, 0])
    first, last, length = _runs(fs, npix)
    count = _add_counts(count, npix, fs, last, length)
    zd, vb = _fold_sections(npix, fs, first, [zs, vs], _strict_less)
    z_new = _inv_mono_u32(~zd)
    # strict z-test vs the standing canvas: chunk ties keep the earlier value
    take = (zd != 0) & (z_new > zbuf)
    zbuf = jnp.where(take, z_new, zbuf)
    steps = jnp.where(take, lax.bitcast_convert_type(vb, jnp.float32), steps)
    return count, steps, zbuf


@functools.partial(jax.jit, static_argnames=("npix", "section", "ties"))
def bin_chunk_kernel_exact16(count, steps, zbuf, flat, z, val, *, npix: int,
                             section: int = STRICT_SECTION, ties: str = "value"):
    """EXACT16_KERNEL: the reference z-test at 16-bit z granularity, with
    one u32 winner payload.

    Operates on the same (count, steps f32, zbuf f32) planes as EXACT — the
    state, merge, colorize and collective machinery are unchanged — but the
    winner payload inside the pipeline is ONE u32 instead of EXACT_KERNEL's
    two: the high half is the descending image of z's 16-bit mono bucket,
    the low half the value's f16 bits.

    Precision contract (documented deviations from EXACT, and the only
    ones — tested in tests/test_exact16.py):

    - z is quantized to its IEEE-754 bucket at 7 mantissa bits (the top 16
      bits of the monotone u32 map: sign + 8 exponent + 7 mantissa), i.e.
      buckets of 2^-7 relative width. The z-test compares BUCKETS with the
      reference's strict ``z2 > zbuf`` rule (src/lib.rs:818-833): a
      strictly greater bucket wins; bucket ties keep the earliest-emitted
      value (the stable sort preserves emission order, exactly EXACT_KERNEL's
      tie discipline at bucket granularity).
    - the stored zbuf is the bucket's LOWER edge — a monotone idempotent
      quantizer, so cross-chunk and cross-state compares stay consistent
      (every standing z already is a bucket edge).
    - the stored value passes through float16 (~2^-11 relative; subnormal
      floor ~6e-8). NaN survives the round-trip; the palette clamp handles
      it identically to EXACT.

    Candidacy is gated at pack time like :func:`ops.binning.pack_zv`:
    points with z <= -1.0 can never beat the -1.0 sentinel under a strict
    test (src/lib.rs:693, 821) and pack to the "no winner" key, which also
    keeps the bucket-lower-edge decode from resurrecting them.

    ``ties`` picks the deterministic representative among bucket-tied
    points (both are inside the documented quantization deviation — any
    point within one bucket of the true max z can be the winner either
    way, and neither is EXACT's max-exact-z pick):

    - ``"value"`` (default): the smallest f16 bit-pattern of the top
      bucket wins (within a chunk; cross-chunk bucket ties keep the
      earlier chunk), via the unstable PAIR sort on
      (flat, bucket-key<<16 | f16-value) — XLA's 2-operand sort. The
      flagship KERNEL/PACKED packing resolves its (finer) z-key ties
      value-ordered too (max packed, ops/binning.pack_zv), so this
      deviation class is parity-proven at tone-map tolerance.
    - ``"earliest"``: the first-emitted point of the top bucket wins —
      EXACT_KERNEL's stream-order discipline (src/lib.rs:818-833 at
      bucket granularity). Under ``jax_enable_x64`` this rides a
      2-operand UNSTABLE sort on a packed u64 key
      ``flat | bucket | emission-index`` (the emission bits make every
      key unique, so instability is semantics-free) with the f16 value
      as payload; a u32 repack cannot fit (21 flat + 16 bucket + 19
      emission bits = 56). Without x64 (u64 unavailable) it falls back to
      the stable 3-operand sort with the value riding as a u16 operand —
      bit-identical results either way (tests/test_exact16.py).
    """
    z = jnp.where(z == 0.0, jnp.float32(0.0), z.astype(jnp.float32))
    k16 = _mono_u32(z) >> 16
    # ascending sort key = descending z bucket; 0xFFFF = dead (z <= -1.0,
    # incl. the NaN -> -inf canonicalization) so dead points sort to the
    # back of their pixel run and a live first-of-run is the bucket winner
    sk = jnp.where(z > -1.0, (~k16) & jnp.uint32(0xFFFF), jnp.uint32(0xFFFF))
    val16 = lax.bitcast_convert_type(val.astype(jnp.float16), jnp.uint16)
    if ties == "value":
        pk4 = jnp.where(sk == jnp.uint32(0xFFFF), jnp.uint32(0xFFFF) << 16,
                        (sk << 16) | val16)
        f, pk4_s = _sections(npix, flat, [pk4], section, [0xFFFF << 16], stable=False)
        packed4 = jnp.where(pk4_s >> 16 == jnp.uint32(0xFFFF), jnp.uint32(0), pk4_s)
    else:
        assert ties == "earliest", ties
        sec = min(section, _round_pow2(flat.size))
        ebits = sec.bit_length() - 1
        if jax.config.jax_enable_x64 and npix.bit_length() + 16 + ebits <= 64:
            # u64 fast path: one unique key per point (flat | bucket |
            # within-section emission index) sorts unstably through XLA's
            # 2-operand sort; uniqueness makes the order total, so the
            # result is bit-identical to the stable 3-operand fallback below
            fu, sku, v16 = _pad_sections(npix, flat, [sk, val16], section,
                                         [0xFFFF, 0])
            emission = lax.broadcasted_iota(jnp.uint64, fu.shape, 1)
            key = ((fu.astype(jnp.uint64) << (16 + ebits))
                   | (sku.astype(jnp.uint64) << ebits) | emission)
            key, v16_s = lax.sort((key, v16), dimension=1, num_keys=1,
                                  is_stable=False)
            f = (key >> (16 + ebits)).astype(jnp.uint32)
            sk_s = ((key >> ebits) & jnp.uint64(0xFFFF)).astype(jnp.uint32)
        else:
            f, sk_s, v16_s = _sections(npix, flat, [sk.astype(jnp.uint16), val16],
                                       section, [0xFFFF, 0])
            sk_s = sk_s.astype(jnp.uint32)
        packed4 = jnp.where(sk_s == jnp.uint32(0xFFFF), jnp.uint32(0),
                            (sk_s << 16) | v16_s.astype(jnp.uint32))
    # 0 == "no winner" (a live sk is never 0: that would need
    # mono(z) >= 0xFFFF0000, beyond float32's finite range)
    first, last, length = _runs(f, npix)
    count = _add_counts(count, npix, f, last, length)
    # value ties compare the full u32 (bucket, then f16 bits): the smallest
    # f16 value of the top bucket across ALL sections of a chunk
    rule = _strict_less if ties == "value" else _strict_less_bucket
    (pk,) = _fold_sections(npix, f, first, [packed4], rule)
    # decode: bucket lower edge (monotone + idempotent), f16 value bits
    z_q = _inv_mono_u32((~(pk >> 16) & jnp.uint32(0xFFFF)) << 16)
    take = (pk != 0) & (z_q > zbuf)
    zbuf = jnp.where(take, z_q, zbuf)
    v = lax.bitcast_convert_type(
        (pk & jnp.uint32(0xFFFF)).astype(jnp.uint16), jnp.float16
    ).astype(jnp.float32)
    steps = jnp.where(take, v, steps)
    return count, steps, zbuf


@functools.partial(jax.jit, static_argnames=("npix", "section", "flood_gate"))
def bin_chunk_kernel_depth(zbuf, flat, z, *, npix: int,
                           section: int = MAX_KEY_SECTION, flood_gate: bool = True):
    """DEPTH-semantics accumulation through the sort-bin pipeline.

    A depth render needs only the per-pixel max z (src/lib.rs:875-899 reads
    nothing else). KERNEL's machinery runs with the winner key set to the
    monotone-u32 image of z: the per-pixel run max IS the max depth.

    ``zbuf`` is the flattened (npix,) f32 plane with the -1.0 sentinel
    (src/lib.rs:693); mono keys are compared in u32 space and mapped back,
    which preserves the sentinel exactly (the map is a bijection). A key of
    0 corresponds to -NaN, which the step function can never emit (NaN z
    is canonicalized to -inf), so it never beats any standing value.
    Pixel-0 floods are evicted before the sort (:func:`_flood_gated`).
    """
    # canonicalize zero sign: the monotone map splits -0.0 / +0.0 into
    # adjacent keys while the reference's float compare ties them
    z = jnp.where(z == 0.0, jnp.float32(0.0), z.astype(jnp.float32))
    zm = _mono_u32(z)
    is0 = flat == 0

    def run(f):
        fs, zs = _sections(npix, f, [zm], section, [0], stable=False)
        _, last, _ = _runs(fs, npix)
        return _mono_u32(zbuf).at[_at(npix, fs, last)].max(zs.reshape(-1), mode="drop")

    def evicted(_):
        zm0 = jnp.max(jnp.where(is0, zm, jnp.uint32(0)))
        return run(jnp.where(is0, jnp.int32(npix), flat)).at[0].max(zm0)

    return (_inv_mono_u32(_flood_gated(flat, evicted, lambda _: run(flat), flood_gate)),)
