"""EXACT16_KERNEL: the documented precision contract, and nothing else.

The mode promises (ops/kernel_binning.bin_chunk_kernel_exact16): EXACT's
plane layout and reference z-test discipline (strict ``z2 > zbuf``,
src/lib.rs:818-833, earliest-wins ties) with exactly two deviations —
z compared/stored at its 16-bit mono-bucket lower edge, values carried
through float16. Every test here pins one clause of that contract; on the
GPU the same code is certified against the quantized host reference
(strange_attractor_tpu/certify.py) by chip_smoke.py and bench.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from strange_attractor_tpu.config import BinStrategy
from strange_attractor_tpu.ops import kernel_binning as kb


def _q_edge(z):
    """The documented quantizer: 16-bit mono-bucket lower edge."""
    u = np.float32(z)
    u = np.where(u == 0.0, np.float32(0.0), u)
    b = np.atleast_1d(u).view(np.uint32)
    mono = np.where(b >> 31 == 1, ~b, b | np.uint32(0x80000000))
    edge = ((mono >> 16) << 16).astype(np.uint32)
    out = np.where(edge < 0x80000000, ~edge,
                   edge & np.uint32(0x7FFFFFFF)).astype(np.uint32).view(np.float32)
    return out.reshape(np.shape(z)) if np.shape(z) else out[0]


def _run(npix, flat, z, val, section=1 << 10, state=None, ties="earliest"):
    if state is None:
        state = (jnp.zeros((npix,), jnp.uint32),
                 jnp.zeros((npix,), jnp.float32),
                 jnp.full((npix,), -1.0, jnp.float32))
    return kb.bin_chunk_kernel_exact16(
        *state,
        jnp.asarray(flat, jnp.int32),
        jnp.asarray(z, jnp.float32),
        jnp.asarray(val, jnp.float32),
        npix=npix, section=section, ties=ties,
    )


def test_greater_bucket_wins_any_order():
    # two z in distinct 16-bit buckets: the greater bucket wins regardless
    # of emission order; zbuf stores the winner's bucket lower edge
    npix = 256
    for order in ([0.5, 0.25], [0.25, 0.5]):
        cnt, st, zb = _run(npix, [7, 7], order, [1.0, 2.0])
        win = float(np.argmax(order)) + 1.0
        assert int(cnt[7]) == 2
        assert float(st[7]) == win
        assert float(zb[7]) == _q_edge(max(order))


def test_same_bucket_earliest_wins():
    # z values distinct in f32 but identical at 7 mantissa bits: a bucket
    # tie — the reference's strict > keeps the EARLIEST emitted value,
    # whichever of the two exact z is larger
    z_hi = np.float32(0.5 * (1 + 3 / 256))   # same bucket as below
    z_lo = np.float32(0.5 * (1 + 2.5 / 256))
    assert _q_edge(z_hi) == _q_edge(z_lo)
    npix = 128
    cnt, st, zb = _run(npix, [3, 3], [z_lo, z_hi], [11.0, 22.0])
    assert float(st[3]) == 11.0  # earlier point kept despite smaller exact z
    cnt, st, zb = _run(npix, [3, 3], [z_hi, z_lo], [22.0, 11.0])
    assert float(st[3]) == 22.0


def test_signed_zero_bucket_tie():
    # -0.0 and +0.0 compare equal in the reference's float test; the
    # canonicalization puts them in one bucket and the earlier point wins
    npix = 128
    cnt, st, zb = _run(npix, [5, 5], [-0.0, 0.0], [1.5, 2.5])
    assert float(st[5]) == 1.5
    cnt, st, zb = _run(npix, [5, 5], [0.0, -0.0], [2.5, 1.5])
    assert float(st[5]) == 2.5
    assert float(zb[5]) == 0.0


def test_dead_points_counted_never_win():
    # z <= -1.0 (incl. the NaN -> -inf canonicalization) can never beat the
    # -1.0 sentinel under strict >: counted, planes untouched
    npix = 128
    cnt, st, zb = _run(npix, [9, 9, 9], [-1.0, -2.0, -np.inf], [5.0, 6.0, 7.0])
    assert int(cnt[9]) == 3
    assert float(st[9]) == 0.0
    assert float(zb[9]) == -1.0
    # a live point among dead ones wins regardless of position
    cnt, st, zb = _run(npix, [9, 9, 9], [-2.0, 0.125, -np.inf], [5.0, 6.0, 7.0])
    assert float(st[9]) == 6.0
    assert float(zb[9]) == _q_edge(0.125)


def test_value_passes_through_f16():
    npix = 128
    vals = np.array([0.1, 1.0 / 3.0, 0.9990234375], np.float32)  # last is f16-exact
    for v in vals:
        cnt, st, zb = _run(npix, [2], [0.25], [v])
        assert float(st[2]) == np.float32(np.float16(v))
    # NaN value survives the round-trip (palette clamp handles it downstream,
    # same as EXACT)
    cnt, st, zb = _run(npix, [2], [0.25], [np.nan])
    assert np.isnan(float(st[2]))


def test_cross_chunk_bucket_tie_keeps_standing():
    # chunk 1 sets a winner; chunk 2 lands in the SAME bucket -> standing
    # (earlier) value kept; a strictly greater bucket still wins
    npix = 128
    z1 = np.float32(0.5)
    z_same = np.float32(0.5 * (1 + 1 / 512))  # same bucket as 0.5
    assert _q_edge(z1) == _q_edge(z_same)
    state = _run(npix, [4], [z1], [1.0])
    state = _run(npix, [4], [z_same], [9.0], state=state)
    assert float(state[1][4]) == 1.0
    state = _run(npix, [4], [1.0], [3.0], state=state)
    assert float(state[1][4]) == 3.0
    assert int(state[0][4]) == 3


def test_value_ties_smallest_f16_wins():
    # ties="value": among bucket-tied points the smallest f16 bit-pattern
    # wins, across sections of one chunk (full-u32 flush compare)
    z_hi = np.float32(0.5 * (1 + 3 / 256))
    z_lo = np.float32(0.5 * (1 + 2.5 / 256))
    assert _q_edge(z_hi) == _q_edge(z_lo)
    npix = 128
    # order-independent: both emission orders keep the smaller value
    for vals in ([22.0, 11.0], [11.0, 22.0]):
        cnt, st, zb = _run(npix, [3, 3], [z_lo, z_hi], vals, ties="value")
        assert float(st[3]) == 11.0
    # cross-section: > 1024 points apart with section=1<<10
    n = 2048
    flat = np.full(n, 17)
    z = np.full(n, -2.0, np.float32)
    val = np.zeros(n, np.float32)
    z[10], val[10] = z_hi, 22.0
    z[2000], val[2000] = z_lo, 11.0
    cnt, st, zb = _run(npix, flat, z, val, ties="value")
    assert float(st[17]) == 11.0
    # distinct buckets: greater bucket wins regardless of value
    cnt, st, zb = _run(npix, [3, 3], [0.25, 0.5], [1.0, 2.0], ties="value")
    assert float(st[3]) == 2.0


def test_value_ties_cross_chunk_keeps_standing():
    npix = 128
    z1 = np.float32(0.5)
    z_same = np.float32(0.5 * (1 + 1 / 512))
    assert _q_edge(z1) == _q_edge(z_same)
    state = _run(npix, [4], [z1], [9.0], ties="value")
    state = _run(npix, [4], [z_same], [1.0], ties="value", state=state)
    assert float(state[1][4]) == 9.0  # earlier chunk keeps the bucket tie


def test_out_of_bounds_dropped():
    npix = 64
    cnt, st, zb = _run(npix, [npix, npix, 1], [0.5, 0.5, 0.5], [1.0, 1.0, 2.0])
    assert int(cnt.sum()) == 1
    assert float(st[1]) == 2.0


def test_matches_exact_when_buckets_distinct():
    # random stream with z snapped to bucket edges and f16-exact values:
    # EXACT16 must agree with full EXACT_KERNEL bit-for-bit
    rng = np.random.default_rng(3)
    npix = 512
    n = 4096
    flat = rng.integers(0, npix, n)
    z = _q_edge(rng.normal(0, 0.5, n).astype(np.float32))
    val = (rng.integers(0, 1024, n) / 1024).astype(np.float16).astype(np.float32)
    got = _run(npix, flat, z, val)
    cnt_e = jnp.zeros((npix,), jnp.uint32)
    st_e = jnp.zeros((npix,), jnp.float32)
    zb_e = jnp.full((npix,), -1.0, jnp.float32)
    want = kb.bin_chunk_kernel_exact(
        cnt_e, st_e, zb_e, jnp.asarray(flat, jnp.int32),
        jnp.asarray(z, jnp.float32), jnp.asarray(val, jnp.float32),
        npix=npix, section=1 << 10,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_end_to_end_render_close_to_exact():
    # full render through render(): identical counts (counting is exact in
    # every strategy), tone-mapped output within quantization tolerance
    import jax

    from strange_attractor_tpu import colorize, presets, render
    from strange_attractor_tpu.utils.export import convert_format

    cfg = presets.poisson_saturne(
        iterations=120_000, width=96, height=54, lanes=256, chunk_steps=64,
        warmup=200, seed=5,
    )
    st16 = render(cfg.replace(bin_strategy=BinStrategy.EXACT16_KERNEL),
                  key=jax.random.PRNGKey(1))
    st_ex = render(cfg.replace(bin_strategy=BinStrategy.EXACT_KERNEL),
                   key=jax.random.PRNGKey(1))
    assert st16.strategy == BinStrategy.EXACT  # plane layout is EXACT's
    np.testing.assert_array_equal(np.asarray(st16.count), np.asarray(st_ex.count))
    # zbuf within one bucket below the exact depth
    zb16, zbe = np.asarray(st16.zbuf), np.asarray(st_ex.zbuf)
    lit = zbe != -1.0
    assert (zb16[lit] <= zbe[lit]).all()
    assert np.all(zbe[lit] - zb16[lit] <= np.abs(zbe[lit]) * 2.0**-6 + 1e-6)
    img16 = np.asarray(convert_format(colorize(cfg, st16), False, True))
    img_ex = np.asarray(convert_format(colorize(cfg, st_ex), False, True))
    mad = np.abs(img16.astype(np.float64) - img_ex.astype(np.float64)).mean() / 255
    assert mad < 0.02, mad


# --- the u64 earliest-ties fast path (jax_enable_x64 only) ---------------


def _run_x64(npix, flat, z, val, section=1 << 10, state=None):
    """Run ties='earliest' with x64 enabled, taking the u64 key branch."""
    import jax

    with jax.enable_x64(True):
        assert jax.config.jax_enable_x64
        return _run(npix, flat, z, val, section=section, state=state,
                    ties="earliest")


def test_u64_earliest_matches_stable_3op_random_stream():
    """The u64 single-key sort (flat | bucket | emission) must be
    bit-identical to the stable 3-operand fallback: emission bits make
    every key unique, so the unstable sort induces the same total order
    the stable sort does."""
    rng = np.random.default_rng(11)
    npix = 1024
    n = 6000  # multiple sections at section=1<<10, plus a padded tail
    flat = rng.integers(0, npix + 1, n)  # incl. out-of-bounds
    z = rng.normal(0, 0.7, n).astype(np.float32)
    z[rng.random(n) < 0.05] = -np.inf  # dead points
    z[rng.random(n) < 0.05] = -0.0
    val = rng.normal(0, 2.0, n).astype(np.float32)
    # concentrate collisions: many same-pixel same-bucket ties
    flat[rng.random(n) < 0.3] = 7
    z[rng.random(n) < 0.3] = np.float32(0.5)
    want = _run(npix, flat, z, val, ties="earliest")
    got = _run_x64(npix, flat, z, val)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_u64_earliest_semantics_direct():
    """The contract clauses hold on the u64 branch itself: same-bucket
    earliest wins, dead points never win, cross-chunk ties keep standing."""
    npix = 128
    z_hi = np.float32(0.5 * (1 + 3 / 256))
    z_lo = np.float32(0.5 * (1 + 2.5 / 256))
    assert _q_edge(z_hi) == _q_edge(z_lo)
    cnt, st, zb = _run_x64(npix, [3, 3], [z_lo, z_hi], [11.0, 22.0])
    assert float(st[3]) == 11.0  # earliest of the tied bucket
    cnt, st, zb = _run_x64(npix, [9, 9, 9], [-1.0, -2.0, -np.inf],
                           [5.0, 6.0, 7.0])
    assert int(cnt[9]) == 3 and float(st[9]) == 0.0 and float(zb[9]) == -1.0
    state = _run_x64(npix, [4], [np.float32(0.5)], [1.0])
    state = _run_x64(npix, [4], [np.float32(0.5 * (1 + 1 / 512))], [9.0],
                     state=state)
    assert float(state[1][4]) == 1.0  # standing chunk keeps the bucket tie


def test_u64_earliest_end_to_end_render_matches_x64_off():
    """Full render() with ties='earliest' under jax_enable_x64 (the CLI
    enables it for --exact16-ties earliest) must produce bit-identical
    planes to the x64-off stable-sort run — the u64 key path changes the
    sort machinery only, and the f32 map loop is x64-clean."""
    import jax

    from strange_attractor_tpu import presets, render
    from strange_attractor_tpu.config import BinStrategy

    cfg = presets.poisson_saturne(
        iterations=90_000, width=96, height=54, lanes=128, chunk_steps=64,
        warmup=200, seed=9, bin_strategy=BinStrategy.EXACT16_KERNEL,
        exact16_ties="earliest",
    )
    want = render(cfg)
    with jax.enable_x64(True):
        got = render(cfg)
    np.testing.assert_array_equal(np.asarray(got.count), np.asarray(want.count))
    np.testing.assert_array_equal(np.asarray(got.steps), np.asarray(want.steps))
    np.testing.assert_array_equal(np.asarray(got.zbuf), np.asarray(want.zbuf))


def test_earliest_without_x64_warns_once():
    """Library callers who set exact16_ties='earliest' without x64 silently
    got the stable-sort fallback; the bin-fn build warns. Bit-identical
    output either way is pinned by
    test_u64_earliest_end_to_end_render_matches_x64_off."""
    import warnings

    import jax

    from strange_attractor_tpu import presets
    from strange_attractor_tpu.config import BinStrategy
    from strange_attractor_tpu.render import _bin_fn

    cfg = presets.poisson_saturne(
        width=32, height=18, bin_strategy=BinStrategy.EXACT16_KERNEL,
        exact16_ties="earliest",
    )
    assert not jax.config.jax_enable_x64
    with pytest.warns(UserWarning, match="stable-sort fallback"):
        _bin_fn(cfg, BinStrategy.EXACT16_KERNEL)
    with jax.enable_x64(True):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _bin_fn(cfg, BinStrategy.EXACT16_KERNEL)
