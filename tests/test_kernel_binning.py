"""KERNEL / EXACT_KERNEL sort-bin pipelines vs the sequential oracle.

The same lax code runs here on the CPU backend and on the GPU (where
chip_smoke.py and bench.py compare it with the oracle at full width); the
binning semantics — count every in-bounds point, packed plane takes the
per-pixel max, EXACT planes follow the strict z-test with earliest-wins
ties, out-of-bounds dropped — must be bit-exact on injected streams.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from strange_attractor_tpu.ops import kernel_binning as kb
from strange_attractor_tpu.ops.binning import pack_zv
from strange_attractor_tpu.oracle import oracle_bin


def _run_kernel(npix, flat, packed, section=1 << 10, state=None):
    if state is None:
        cnt = jnp.zeros((npix,), jnp.uint32)
        pk = jnp.zeros((npix,), jnp.uint32)
    else:
        cnt, pk = state
    return kb.bin_chunk_kernel(
        cnt, pk,
        jnp.asarray(flat, jnp.int32),
        jnp.asarray(packed, jnp.uint32),
        npix=npix, section=section,
    )


def _run_exact(npix, flat, z, val, section=1 << 10, state=None):
    if state is None:
        cnt = jnp.zeros((npix,), jnp.uint32)
        steps = jnp.zeros((npix,), jnp.float32)
        zbuf = jnp.full((npix,), -1.0, jnp.float32)
    else:
        cnt, steps, zbuf = state
    return kb.bin_chunk_kernel_exact(
        cnt, steps, zbuf,
        jnp.asarray(flat, jnp.int32),
        jnp.asarray(z, jnp.float32),
        jnp.asarray(val, jnp.float32),
        npix=npix, section=section,
    )


def _reference(npix, flat, packed):
    cnt = np.zeros(npix + 1, np.uint64)
    pk = np.zeros(npix + 1, np.uint32)
    for f, p in zip(flat, packed):
        cnt[f] += 1
        pk[f] = max(pk[f], p)
    return cnt[:npix].astype(np.uint32), pk[:npix]


@pytest.mark.parametrize("npix", [128 * 128, 320 * 180])
def test_kernel_matches_reference_random(npix):
    rng = np.random.default_rng(0)
    n = 1 << 12
    flat = rng.integers(0, npix, n).astype(np.int32)
    flat[rng.random(n) < 0.05] = npix  # out-of-bounds convention
    packed = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    cnt, pk = _run_kernel(npix, flat, packed)
    want_c, want_p = _reference(npix, flat, packed)
    np.testing.assert_array_equal(np.asarray(cnt), want_c)
    np.testing.assert_array_equal(np.asarray(pk), want_p)


def test_kernel_heavy_duplicates_and_ties():
    """Many points per pixel, exact packed ties, runs spanning row/section
    boundaries — the winner bookkeeping's hard cases."""
    npix = 128 * 128
    rng = np.random.default_rng(1)
    n = 1 << 12
    flat = rng.integers(0, 50, n).astype(np.int32)  # 50 hot pixels
    packed = rng.integers(0, 8, n, dtype=np.uint64).astype(np.uint32)  # tiny value space: ties
    cnt, pk = _run_kernel(npix, flat, packed, section=1 << 9)
    want_c, want_p = _reference(npix, flat, packed)
    np.testing.assert_array_equal(np.asarray(cnt), want_c)
    np.testing.assert_array_equal(np.asarray(pk), want_p)


def test_kernel_accumulates_across_chunks():
    npix = 128 * 128
    rng = np.random.default_rng(2)
    chunks = [
        (rng.integers(0, npix, 600).astype(np.int32),
         rng.integers(0, 2**32, 600, dtype=np.uint64).astype(np.uint32))
        for _ in range(3)
    ]
    state = None
    for flat, packed in chunks:
        state = _run_kernel(npix, flat, packed, state=state)
    all_f = np.concatenate([c[0] for c in chunks])
    all_p = np.concatenate([c[1] for c in chunks])
    want_c, want_p = _reference(npix, all_f, all_p)
    np.testing.assert_array_equal(np.asarray(state[0]), want_c)
    np.testing.assert_array_equal(np.asarray(state[1]), want_p)


def test_kernel_vs_packed_oracle_semantics():
    """End-to-end packed semantics vs oracle_bin through pack_zv: the KERNEL
    strategy must land exactly where the PACKED XLA path lands."""
    npix = 64 * 36
    rng = np.random.default_rng(3)
    n = 3000
    flat = rng.integers(0, npix, n).astype(np.int64)
    oob = rng.random(n) < 0.1
    z = rng.normal(0, 0.5, n).astype(np.float32)
    val = rng.random(n).astype(np.float32)

    packed = np.asarray(pack_zv(jnp.asarray(z), jnp.asarray(val)))
    kflat = np.where(oob, npix, flat).astype(np.int32)
    cnt, pk = _run_kernel(npix, kflat, packed)

    oc, _, _ = oracle_bin(64, 36, np.where(oob, -1, flat), z, val)
    np.testing.assert_array_equal(np.asarray(cnt), oc.astype(np.uint32))
    want_pk = np.zeros(npix + 1, np.uint32)
    for f, p in zip(np.where(oob, npix, flat), packed):
        want_pk[f] = max(want_pk[f], p)
    np.testing.assert_array_equal(np.asarray(pk), want_pk[:npix])


def test_exact_kernel_matches_oracle_bin():
    """EXACT_KERNEL == the sequential oracle on all three planes, including
    the strict z-test with the -1.0 sentinel."""
    npix = 64 * 36
    rng = np.random.default_rng(4)
    n = 4000
    flat = rng.integers(0, npix, n).astype(np.int64)
    oob = rng.random(n) < 0.1
    z = rng.normal(0, 0.5, n).astype(np.float32)
    z[rng.random(n) < 0.05] = -2.0  # below the sentinel: counted, never wins
    val = rng.random(n).astype(np.float32)

    cnt, steps, zbuf = _run_exact(npix, np.where(oob, npix, flat).astype(np.int32), z, val)
    oc, os_, oz = oracle_bin(64, 36, np.where(oob, -1, flat), z, val)
    np.testing.assert_array_equal(np.asarray(cnt), oc.astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(zbuf), oz)
    np.testing.assert_array_equal(np.asarray(steps), os_)


def test_exact_kernel_tie_semantics():
    """Equal-(pixel, z) duplicates: the EARLIEST-emitted value wins — the
    reference's strict z2 > zbuf applied in stream order, which the XLA
    scatter path can only approximate (its within-chunk ties are
    nondeterministic)."""
    npix = 128 * 128
    flat = np.array([7, 7, 7, 9, 9], np.int32)
    z = np.array([0.5, 0.5, 0.25, 0.5, 0.5], np.float32)
    val = np.array([0.1, 0.9, 0.7, 0.3, 0.4], np.float32)
    cnt, steps, zbuf = _run_exact(npix, flat, z, val)
    assert int(np.asarray(cnt)[7]) == 3 and int(np.asarray(cnt)[9]) == 2
    assert np.asarray(zbuf)[7] == np.float32(0.5)
    assert np.asarray(steps)[7] == np.float32(0.1)  # earliest of the z-tie
    assert np.asarray(steps)[9] == np.float32(0.3)

    # cross-chunk tie: a later chunk tying the standing depth must not win
    state = (cnt, steps, zbuf)
    cnt, steps, zbuf = _run_exact(
        npix, np.array([7], np.int32), np.array([0.5], np.float32),
        np.array([0.99], np.float32), state=state,
    )
    assert np.asarray(steps)[7] == np.float32(0.1)
    # ... but a strictly greater depth does
    cnt, steps, zbuf = _run_exact(
        npix, np.array([7], np.int32), np.array([0.6], np.float32),
        np.array([0.42], np.float32), state=(cnt, steps, zbuf),
    )
    assert np.asarray(steps)[7] == np.float32(0.42)
    assert np.asarray(zbuf)[7] == np.float32(0.6)


def test_exact_kernel_signed_zero_ties():
    """-0.0 and +0.0 are numerically equal: the strict z-test must treat
    them as a tie (earlier point wins), even though the monotone sort key
    would order them (found on-chip; CLAUDE.md zero-canonicalization rule)."""
    npix = 128 * 128
    flat = np.array([3, 3], np.int32)
    z = np.array([-0.0, 0.0], np.float32)
    val = np.array([0.25, 0.75], np.float32)
    cnt, steps, zbuf = _run_exact(npix, flat, z, val)
    assert np.asarray(steps)[3] == np.float32(0.25)  # earlier wins the tie
    assert np.asarray(zbuf)[3] == np.float32(0.0)
    # and the reverse emission order
    cnt, steps, zbuf = _run_exact(npix, flat, z[::-1].copy(), val)
    assert np.asarray(steps)[3] == np.float32(0.25)


def test_exact_kernel_accumulates_across_chunks():
    npix = 96 * 54
    rng = np.random.default_rng(5)
    state = None
    all_parts = []
    for _ in range(3):
        n = 900
        flat = rng.integers(0, npix, n).astype(np.int64)
        z = rng.normal(0, 0.5, n).astype(np.float32)
        val = rng.random(n).astype(np.float32)
        all_parts.append((flat, z, val))
        state = _run_exact(npix, flat.astype(np.int32), z, val, state=state)
    fa = np.concatenate([p[0] for p in all_parts])
    za = np.concatenate([p[1] for p in all_parts])
    va = np.concatenate([p[2] for p in all_parts])
    oc, os_, oz = oracle_bin(96, 54, fa, za, va)
    np.testing.assert_array_equal(np.asarray(state[0]), oc.astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(state[2]), oz)
    np.testing.assert_array_equal(np.asarray(state[1]), os_)


def test_kernel_all_oob_chunk():
    npix = 128 * 128
    flat = np.full(300, npix, np.int32)
    packed = np.full(300, 7, np.uint32)
    cnt, pk = _run_kernel(npix, flat, packed)
    assert int(np.asarray(cnt).sum()) == 0
    assert int(np.asarray(pk).max()) == 0


def test_kernel_strategy_end_to_end_matches_packed():
    """Full render with BinStrategy.KERNEL == BinStrategy.PACKED bit-for-bit
    on the same trajectories (they share pack_zv packing and max/count
    semantics; only the accumulation path differs)."""
    from strange_attractor_tpu import presets, render
    from strange_attractor_tpu.config import BinStrategy
    from strange_attractor_tpu.render import seed_key

    cfg = presets.poisson_saturne(
        width=64, height=36, iterations=24_000, lanes=64, chunk_steps=125, seed=11,
    )
    key = seed_key(cfg)
    st_k = render(cfg.replace(bin_strategy=BinStrategy.KERNEL), key=key)
    st_p = render(cfg.replace(bin_strategy=BinStrategy.PACKED), key=key)
    assert st_k.strategy == BinStrategy.PACKED  # KERNEL stores PACKED planes
    np.testing.assert_array_equal(np.asarray(st_k.count), np.asarray(st_p.count))
    np.testing.assert_array_equal(np.asarray(st_k.packed), np.asarray(st_p.packed))


def test_exact_kernel_end_to_end_matches_exact():
    """Full render with EXACT_KERNEL == EXACT bit-for-bit on the same
    trajectories (real orbits have no exact z ties, so the scatter path's
    tie nondeterminism cannot show)."""
    from strange_attractor_tpu import presets, render
    from strange_attractor_tpu.config import BinStrategy
    from strange_attractor_tpu.render import seed_key

    cfg = presets.poisson_saturne(
        width=64, height=36, iterations=24_000, lanes=64, chunk_steps=125, seed=13,
    )
    key = seed_key(cfg)
    st_k = render(cfg.replace(bin_strategy=BinStrategy.EXACT_KERNEL), key=key)
    st_e = render(cfg.replace(bin_strategy=BinStrategy.EXACT), key=key)
    assert st_k.strategy == BinStrategy.EXACT
    np.testing.assert_array_equal(np.asarray(st_k.count), np.asarray(st_e.count))
    np.testing.assert_array_equal(np.asarray(st_k.zbuf), np.asarray(st_e.zbuf))
    np.testing.assert_array_equal(np.asarray(st_k.steps), np.asarray(st_e.steps))


def test_kernel_resumes_packed_state():
    """A PACKED-plane state is plane-compatible with the KERNEL path:
    progressive resume through either strategy accumulates consistently."""
    import jax
    from strange_attractor_tpu import presets, render
    from strange_attractor_tpu.config import BinStrategy

    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=8_000, lanes=64, chunk_steps=125, seed=5,
    )
    st1 = render(cfg.replace(bin_strategy=BinStrategy.PACKED), key=jax.random.PRNGKey(0))
    st2 = render(
        cfg.replace(bin_strategy=BinStrategy.KERNEL), st1, key=jax.random.PRNGKey(1)
    )
    st2_ref = render(
        cfg.replace(bin_strategy=BinStrategy.PACKED), st1, key=jax.random.PRNGKey(1)
    )
    np.testing.assert_array_equal(np.asarray(st2.count), np.asarray(st2_ref.count))
    np.testing.assert_array_equal(np.asarray(st2.packed), np.asarray(st2_ref.packed))
    assert int(st2.count.sum()) > int(st1.count.sum())


def test_depth_kernel_matches_scatter_depth():
    """DEPTH_KERNEL == scatter DEPTH max-z per pixel, incl. zero signs."""
    import numpy as np
    import jax.numpy as jnp

    from strange_attractor_tpu.ops import binning, kernel_binning as kb

    rng = np.random.default_rng(11)
    npix = 64 * 36
    n = 4096
    flat = rng.integers(0, npix + 1, n).astype(np.int32)  # npix = out of bounds
    z = rng.normal(size=n).astype(np.float32)
    z[:16] = 0.0
    z[16:32] = -0.0  # monotone-map tie edge
    zbuf0 = jnp.full((npix,), -1.0, jnp.float32)

    (ref,) = binning.bin_chunk_depth(zbuf0, jnp.asarray(flat), jnp.asarray(z))
    (got,) = kb.bin_chunk_kernel_depth(
        zbuf0, jnp.asarray(flat), jnp.asarray(z), npix=npix, section=1 << 10,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    # accumulate a second chunk on top: merge must stay a plain max
    flat2 = rng.integers(0, npix + 1, n).astype(np.int32)
    z2 = rng.normal(size=n).astype(np.float32)
    (ref2,) = binning.bin_chunk_depth(ref, jnp.asarray(flat2), jnp.asarray(z2))
    (got2,) = kb.bin_chunk_kernel_depth(
        got, jnp.asarray(flat2), jnp.asarray(z2), npix=npix, section=1 << 10,
    )
    np.testing.assert_array_equal(np.asarray(got2), np.asarray(ref2))


def test_kernel_uniform_rows_fast_path():
    """Floods of one pixel that fill whole sections, with ragged edges, so
    runs span section boundaries and the run length carries the count of a
    whole section: must stay bit-exact."""
    npix = 320 * 180
    rng = np.random.default_rng(7)
    # section 512: floods of several whole sections with ragged edges so
    # single-run and mixed sections interleave
    parts = [
        np.full(1400, 7, np.int32),            # flood pixel 7 (~3 sections)
        np.full(900, 4096 + 13, np.int32),     # flood of another pixel
        rng.integers(0, npix, 700).astype(np.int32),  # general filler
        np.full(300, npix, np.int32),          # out-of-bounds sentinel run
        np.full(796, 7, np.int32),             # second flood of pixel 7
    ]
    flat = np.concatenate(parts)
    packed = rng.integers(0, 2**32, flat.size, dtype=np.uint64).astype(np.uint32)
    cnt, pk = _run_kernel(npix, flat, packed, section=1 << 9)
    want_c, want_p = _reference(npix, flat, packed)
    np.testing.assert_array_equal(np.asarray(cnt), want_c)
    np.testing.assert_array_equal(np.asarray(pk), want_p)


def test_exact_kernel_uniform_rows_fast_path():
    """Same flood shapes through EXACT_KERNEL (winner marks at each run's
    FIRST element): z ties inside a flood must still resolve to the
    earliest-emitted value, across sections too."""
    npix = 320 * 180
    rng = np.random.default_rng(8)
    parts = [
        np.full(1400, 7, np.int32),
        np.full(900, 4096 + 13, np.int32),
        rng.integers(0, npix, 700).astype(np.int32),
        np.full(300, npix, np.int32),
        np.full(796, 7, np.int32),
    ]
    flat = np.concatenate(parts)
    n = flat.size
    z = np.round(rng.normal(0, 0.5, n) * 8).astype(np.float32) / 8  # coarse: ties
    val = rng.random(n).astype(np.float32)
    cnt, steps, zbuf = _run_exact(npix, flat, z, val, section=1 << 9)
    ec = np.zeros(npix + 1, np.uint64)
    es = np.zeros(npix + 1, np.float32)
    ez = np.full(npix + 1, -1.0, np.float32)
    for f, zz, vv in zip(flat, z, val):
        ec[f] += 1
        if zz > ez[f]:
            ez[f] = zz
            es[f] = vv
    np.testing.assert_array_equal(np.asarray(cnt), ec[:npix].astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(zbuf), ez[:npix])
    np.testing.assert_array_equal(np.asarray(steps), es[:npix])


def test_kernel_pixel0_flood_eviction():
    """Flood-heavy streams (the solar-sail NaN quirk bins 35-40% of all
    points at pixel (0,0), src/lib.rs:789-812): the pixel-0 eviction and
    the out-of-bounds tail of each sorted section must stay bit-exact, both
    within one chunk and accumulating onto a standing canvas whose pixel 0
    already holds a value."""
    npix = 128 * 128
    rng = np.random.default_rng(21)
    n = 1 << 12
    flat = rng.integers(0, npix, n).astype(np.int32)
    flat[rng.random(n) < 0.40] = 0           # flood
    flat[rng.random(n) < 0.05] = npix        # out-of-bounds convention
    packed = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    cnt, pk = _run_kernel(npix, flat, packed)
    want_c, want_p = _reference(npix, flat, packed)
    np.testing.assert_array_equal(np.asarray(cnt), want_c)
    np.testing.assert_array_equal(np.asarray(pk), want_p)

    # second chunk with no pixel-0 points: the standing pixel-0 value must
    # survive untouched through the eviction's no-op fixup
    flat2 = rng.integers(1, npix, n).astype(np.int32)
    packed2 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    cnt2, pk2 = _run_kernel(npix, flat2, packed2, state=(cnt, pk))
    want_c2, want_p2 = _reference(npix, np.concatenate([flat, flat2]),
                                  np.concatenate([packed, packed2]))
    np.testing.assert_array_equal(np.asarray(cnt2), want_c2)
    np.testing.assert_array_equal(np.asarray(pk2), want_p2)


def test_kernel_all_pixel0_chunk():
    """Degenerate chunk: every point evicted -> the sort sees only
    out-of-bounds points and the fixup carries the whole update."""
    npix = 128 * 128
    n = 2048
    flat = np.zeros(n, np.int32)
    packed = np.arange(n, dtype=np.uint32)
    cnt, pk = _run_kernel(npix, flat, packed)
    assert int(cnt[0]) == n
    assert int(pk[0]) == n - 1
    assert int(np.asarray(cnt).sum()) == n


def test_depth_kernel_pixel0_flood():
    """DEPTH_KERNEL's eviction folds flood z's through the monotone-u32 max,
    including negatives and the +/-0.0 tie."""
    import jax.numpy as jnp

    from strange_attractor_tpu.ops import binning, kernel_binning as kb

    rng = np.random.default_rng(22)
    npix = 64 * 36
    n = 4096
    flat = rng.integers(0, npix + 1, n).astype(np.int32)
    flat[rng.random(n) < 0.35] = 0
    z = rng.normal(size=n).astype(np.float32)
    z[:8] = 0.0
    z[8:16] = -0.0
    zbuf0 = jnp.full((npix,), -1.0, jnp.float32)
    (ref,) = binning.bin_chunk_depth(zbuf0, jnp.asarray(flat), jnp.asarray(z))
    (got,) = kb.bin_chunk_kernel_depth(
        zbuf0, jnp.asarray(flat), jnp.asarray(z), npix=npix, section=1 << 10,
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_exact_kernel_pixel0_flood():
    """EXACT under a pixel-0 flood (never-winning -inf z interleaved with
    legitimate pixel-0 points): strict z-test, earliest-wins ties, exact
    count. (EXACT does not evict floods, so this pins the plain path's
    semantics on the flood shape.)"""
    npix = 64 * 36
    rng = np.random.default_rng(23)
    n = 4096
    flat = rng.integers(0, npix, n).astype(np.int32)
    flood = rng.random(n) < 0.4
    flat[flood] = 0
    z = rng.normal(0, 0.5, n).astype(np.float32)
    z = np.round(z * 32) / 32  # force exact ties
    z[flood] = -np.inf         # NaN-quirk floods arrive as -inf
    # a few legitimate pixel-0 hits with real z, interleaved with floods
    legit = rng.choice(np.nonzero(~flood)[0], 40, replace=False)
    flat[legit] = 0
    val = rng.random(n).astype(np.float32)
    cnt, st, zb = _run_exact(npix, flat, z, val)

    ec = np.zeros(npix, np.uint64)
    es = np.zeros(npix, np.float32)
    ez = np.full(npix, -1.0, np.float32)
    for f, zz, vv in zip(flat, z, val):
        if f >= npix:
            continue
        ec[f] += 1
        if zz > ez[f]:
            ez[f] = zz
            es[f] = vv
    np.testing.assert_array_equal(np.asarray(cnt), ec.astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(zb), ez)
    np.testing.assert_array_equal(np.asarray(st), es)


def test_kernel_flood_gate_off_bit_exact():
    """flood_gate=False (the vmapped sequence paths) always-evicts and must
    stay bit-exact on gated-above-threshold, below-threshold, and zero-flood
    streams alike."""
    npix = 128 * 128
    rng = np.random.default_rng(33)
    n = 1 << 12
    for flood_frac in (0.0, 0.01, 0.4):
        flat = rng.integers(1, npix, n).astype(np.int32)
        if flood_frac:
            flat[rng.random(n) < flood_frac] = 0
        packed = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        cnt, pk = kb.bin_chunk_kernel(
            jnp.zeros((npix,), jnp.uint32), jnp.zeros((npix,), jnp.uint32),
            jnp.asarray(flat), jnp.asarray(packed),
            npix=npix, section=1 << 10, flood_gate=False,
        )
        want_c, want_p = _reference(npix, flat, packed)
        np.testing.assert_array_equal(np.asarray(cnt), want_c)
        np.testing.assert_array_equal(np.asarray(pk), want_p)


def test_vmapped_bin_runs_single_pipeline():
    """Under vmap a data-dependent lax.cond lowers to select_n and executes
    BOTH branches; the sequence paths must therefore bin with the static
    always-evict variant. Guard: the vmapped jaxpr of the flood_gate=False
    kernel contains exactly ONE sort, and no cond/select over a second
    pipeline (the gated variant under vmap shows two sorts)."""
    import jax

    npix = 64 * 64
    n = 1 << 10

    def binned(gate):
        def f(flat, packed):
            return kb.bin_chunk_kernel(
                jnp.zeros((npix,), jnp.uint32), jnp.zeros((npix,), jnp.uint32),
                flat, packed, npix=npix, section=256,
                flood_gate=gate,
            )
        return jax.make_jaxpr(jax.vmap(f))(
            jnp.zeros((3, n), jnp.int32), jnp.zeros((3, n), jnp.uint32)
        )

    def count_sorts(jaxpr):
        total = 0
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "sort":
                total += 1
            for v in eqn.params.values():
                for sub in jax.core.jaxprs_in_params({"_": v}):
                    total += count_sorts(sub)
        return total

    fast = count_sorts(binned(False).jaxpr)
    slow = count_sorts(binned(True).jaxpr)
    assert fast == 1, f"always-evict path must sort once, saw {fast}"
    assert slow >= 2, f"expected the gated vmap path to duplicate work, saw {slow}"
