"""Lit-bbox cropped delivery (render.colorize_convert_fetch crop path).

The crop mechanism may never change a delivered byte: the first call per
deliverable fetches the full canvas and learns the lit bbox + unlit fill
from the rider; later calls crop to the cached bbox and re-verify via their
own rider, falling back to the full fetch on any mismatch. Every test here
pins the assembled frame byte-identical to the unbanded colorize + convert
reference across combos, cache states, and adversarial (poisoned) caches.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from strange_attractor_tpu import presets
from strange_attractor_tpu.config import (
    BinStrategy,
    BrightnessConstants,
    Colors,
    RenderKind,
)
from strange_attractor_tpu.render import (
    _CROP_CACHE,
    _crop_window,
    colorize,
    colorize_convert_fetch,
    render,
)
from strange_attractor_tpu.runtime import RenderState
from strange_attractor_tpu.utils.export import convert_format_device


def _plain(cfg, st, transparent, eight_bit):
    return np.asarray(
        jax.device_get(
            convert_format_device(colorize(cfg, st), transparent, eight_bit)
        )
    )


@pytest.fixture(autouse=True)
def _isolated_crop_cache():
    """Snapshot/restore the process-global crop cache: the poisoning tests
    here must not leak corrupted entries into other modules' deliveries."""
    saved = dict(_CROP_CACHE)
    yield
    _CROP_CACHE.clear()
    _CROP_CACHE.update(saved)


@pytest.fixture()
def small_render():
    cfg = presets.poisson_saturne(
        iterations=150_000, width=192, height=104, seed=3, silent=True
    )
    return cfg, render(cfg, key=jax.random.PRNGKey(3))


@pytest.mark.parametrize("transparent", [False, True])
@pytest.mark.parametrize("eight_bit", [False, True])
def test_crop_learn_then_crop_is_bit_exact(small_render, transparent, eight_bit):
    cfg, st = small_render
    ref = _plain(cfg, st, transparent, eight_bit)
    # call 1 learns (full fetch + rider), calls 2-3 ride the cached crop
    for call in range(3):
        got = colorize_convert_fetch(
            cfg, st, transparent=transparent, eight_bit=eight_bit, crop=True
        )
        np.testing.assert_array_equal(got, ref, err_msg=f"call {call}")


def test_crop_cache_learned_a_proper_subwindow(small_render):
    cfg, st = small_render
    colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, crop=True)
    entries = [
        v
        for k, v in _CROP_CACHE.items()
        if k[6] == (cfg.height, cfg.width) and not k[7] and k[8]
    ]
    assert entries, "rider did not populate the crop cache"
    bbox = entries[-1]["bbox"]
    lit = np.asarray(jax.device_get(st.count)) > 0
    rows = np.flatnonzero(lit.any(axis=1))
    cols = np.flatnonzero(lit.any(axis=0))
    assert bbox == (rows[0], rows[-1] + 1, cols[0], cols[-1] + 1)
    assert entries[-1]["fill"] == (0, 0, 0)


def test_poisoned_cache_falls_back_bit_exact(small_render):
    cfg, st = small_render
    ref = _plain(cfg, st, False, True)
    colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, crop=True)
    for key in list(_CROP_CACHE):
        # a bbox that cannot contain the real support -> rider must reject
        _CROP_CACHE[key] = {"bbox": (48, 64, 64, 128), "fill": (0, 0, 0)}
    got = colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, crop=True)
    np.testing.assert_array_equal(got, ref)
    # and a wrong FILL with a correct bbox must also be rejected
    colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, crop=True)
    for key, v in list(_CROP_CACHE.items()):
        _CROP_CACHE[key] = {"bbox": v["bbox"], "fill": (1, 2, 3)}
    got = colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, crop=True)
    np.testing.assert_array_equal(got, ref)
    # a bbox beyond the canvas inverts under _crop_window's clamping and
    # must resolve to the full fetch, not an empty band list
    for key in list(_CROP_CACHE):
        _CROP_CACHE[key] = {"bbox": (400, 900, 500, 1000), "fill": (0, 0, 0)}
    got = colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, crop=True)
    np.testing.assert_array_equal(got, ref)


def test_positive_brightness_offset_nonzero_fill(small_render):
    cfg, st = small_render
    cfg = presets.poisson_saturne(
        iterations=150_000, width=192, height=104, seed=3, silent=True,
        colors=Colors(brightness=BrightnessConstants(offset=0.1)),
    )
    ref = _plain(cfg, st, False, True)
    assert ref[0, 0].max() > 0, "unlit fill should be nonzero at offset 0.1"
    for _ in range(3):
        got = colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, crop=True)
        np.testing.assert_array_equal(got, ref)


def test_depth_render_and_depth_only_state():
    cfg = presets.poisson_saturne(
        iterations=150_000, width=192, height=104, seed=3, silent=True,
        render=RenderKind.DEPTH, bin_strategy=BinStrategy.DEPTH,
    )
    st = render(cfg, key=jax.random.PRNGKey(3))
    assert st.count is None  # depth-only state: bbox comes from the z plane
    ref = _plain(cfg, st, True, False)
    for _ in range(3):
        got = colorize_convert_fetch(cfg, st, transparent=True, eight_bit=False, crop=True)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("transparent", [False, True])
@pytest.mark.parametrize("eight_bit", [False, True])
def test_depth_wire_reduction_is_bit_exact(transparent, eight_bit):
    """DEPTH deliverables wire ONE gray channel (render._wire_channels):
    the tone map writes (g, g, g, 65535) for every pixel (ops/colorize.py;
    reference src/lib.rs:875-899), so only channel 0 crosses the byte-bound
    link — 3x fewer bytes — and the host replicates the gray and
    synthesizes the constant alpha. Learn + crop calls must stay
    bit-identical to the full-channel unbanded reference."""
    cfg = presets.poisson_saturne(
        iterations=150_000, width=192, height=104, seed=3, silent=True,
        render=RenderKind.DEPTH, bin_strategy=BinStrategy.DEPTH,
    )
    st = render(cfg, key=jax.random.PRNGKey(3))
    ref = _plain(cfg, st, transparent, eight_bit)
    assert ref.shape[-1] == (4 if transparent else 3)
    for call in range(3):
        got = colorize_convert_fetch(
            cfg, st, transparent=transparent, eight_bit=eight_bit, crop=True
        )
        np.testing.assert_array_equal(got, ref, err_msg=f"call {call}")
    # the rider rode in wire channels: the learned fill is ONE value
    entries = [
        v for k, v in _CROP_CACHE.items()
        if k[3] == RenderKind.DEPTH.value and k[6] == (cfg.height, cfg.width)
        and k[7] is transparent and k[8] is eight_bit
    ]
    assert entries and len(entries[-1]["fill"]) == 1


def test_wire_channels_and_expand():
    from strange_attractor_tpu.render import _expand_wire, _wire_channels

    gas = presets.poisson_saturne(silent=True)
    assert _wire_channels(gas, False) == (3, 3)
    assert _wire_channels(gas, True) == (4, 4)
    depth = presets.poisson_saturne(
        silent=True, render=RenderKind.DEPTH, bin_strategy=BinStrategy.DEPTH
    )
    assert _wire_channels(depth, False) == (1, 3)
    assert _wire_channels(depth, True) == (1, 4)
    g = np.arange(6, dtype=np.uint16).reshape(2, 3, 1)
    out = _expand_wire(g, 1, 4)
    assert out.shape == (2, 3, 4) and out.dtype == np.uint16
    for c in range(3):
        np.testing.assert_array_equal(out[..., c], g[..., 0])
    assert (out[..., 3] == 65535).all()
    g8 = g.astype(np.uint8)
    out8 = _expand_wire(g8, 1, 4)
    assert out8.dtype == np.uint8 and (out8[..., 3] == 255).all()
    assert _expand_wire(g, 1, 3).shape == (2, 3, 3)
    assert _expand_wire(g, 3, 3) is g  # identity when every channel is live


def test_empty_state_delivers_full_path(small_render):
    cfg, _ = small_render
    st = RenderState.blank((cfg.height, cfg.width), BinStrategy.PACKED)
    ref = _plain(cfg, st, False, True)
    for _ in range(2):
        got = colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, crop=True)
        np.testing.assert_array_equal(got, ref)
    # an empty bbox must never produce a crop window
    assert _crop_window((cfg.height, 0, cfg.width, 0), cfg.height, cfg.width) is None


def test_full_lit_state_skips_crop(small_render):
    cfg, st = small_render
    full = RenderState(
        count=jnp.ones_like(st.count),
        steps=st.steps, zbuf=st.zbuf, packed=st.packed,
    )
    ref = _plain(cfg, full, False, True)
    for _ in range(2):
        got = colorize_convert_fetch(cfg, full, transparent=False, eight_bit=True, crop=True)
        np.testing.assert_array_equal(got, ref)


def test_progressive_growth_is_caught_by_rider(small_render):
    """Support growth between deliveries (progressive refinement) must be
    caught: the second state lights a pixel outside the learned bbox."""
    cfg, st = small_render
    colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, crop=True)
    colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, crop=True)
    grown = RenderState(
        count=st.count.at[-1, -1].add(7),
        steps=st.steps, zbuf=st.zbuf, packed=st.packed,
    )
    ref = _plain(cfg, grown, False, True)
    got = colorize_convert_fetch(cfg, grown, transparent=False, eight_bit=True, crop=True)
    np.testing.assert_array_equal(got, ref)
    got = colorize_convert_fetch(cfg, grown, transparent=False, eight_bit=True, crop=True)
    np.testing.assert_array_equal(got, ref)


def test_flood_corner_excluded_from_bbox(small_render):
    """The reference's NaN quirk floods pixel (0,0) on escaping presets
    (solar-sail: ~38% of all points), which would pin the lit bbox to the
    origin. The rider excludes the corner from the bbox and carries its
    converted value instead; the host pastes it back — so the crop window
    must NOT extend to the origin and the corner byte must be exact."""
    cfg, st = small_render
    flooded = RenderState(
        count=st.count.at[0, 0].add(500_000),
        steps=st.steps, zbuf=st.zbuf, packed=st.packed,
    )
    ref = _plain(cfg, flooded, False, True)
    assert ref[0, 0].max() > 0, "flood corner should be lit in the reference"
    for call in range(3):
        got = colorize_convert_fetch(
            cfg, flooded, transparent=False, eight_bit=True, crop=True
        )
        np.testing.assert_array_equal(got, ref, err_msg=f"call {call}")
    entries = [
        v for k, v in _CROP_CACHE.items()
        if k[6] == (cfg.height, cfg.width) and not k[7] and k[8]
    ]
    bbox = entries[-1]["bbox"]
    assert bbox[0] > 0 and bbox[2] > 0, (
        f"flood corner leaked into the learned bbox: {bbox}"
    )


def test_flood_corner_outside_window_is_pasted(small_render):
    """Corner OUTSIDE the crop window: an interior-only blob keeps the
    snapped window away from the origin, so the flooded (0,0) byte can
    only arrive via the rider's corner paste."""
    cfg, st = small_render
    blob = jnp.zeros_like(st.count).at[40:60, 130:150].set(9)
    synth = RenderState(
        count=blob.at[0, 0].set(123_456),
        steps=jnp.zeros_like(st.steps).at[40:60, 130:150].set(0.4),
        zbuf=jnp.full_like(st.zbuf, -1.0).at[40:60, 130:150].set(0.2),
        packed=None,
    )
    ref = _plain(cfg, synth, False, True)
    assert ref[0, 0].max() > 0
    for call in range(3):
        got = colorize_convert_fetch(
            cfg, synth, transparent=False, eight_bit=True, crop=True
        )
        np.testing.assert_array_equal(got, ref, err_msg=f"call {call}")
    entries = [
        v for k, v in _CROP_CACHE.items()
        if k[6] == (cfg.height, cfg.width) and not k[7] and k[8]
    ]
    assert entries[-1]["bbox"] == (40, 60, 130, 150)


def test_crop_disabled_matches(small_render):
    cfg, st = small_render
    ref = _plain(cfg, st, False, True)
    got = colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, crop=False)
    np.testing.assert_array_equal(got, ref)


def test_crop_window_snapping():
    # margin of one quantum each side, clamped to the canvas
    assert _crop_window((67, 1038, 325, 1599), 1080, 1920) == (56, 1048, 256, 1664)
    # nearly-full boxes deliver the full canvas (no crop benefit)
    assert _crop_window((0, 1080, 0, 1920), 1080, 1920) is None
    assert _crop_window((2, 1079, 1, 1919), 1080, 1920) is None
    # degenerate/empty
    assert _crop_window((5, 5, 0, 10), 100, 100) is None
