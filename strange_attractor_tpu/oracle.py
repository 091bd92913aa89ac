"""CPU numpy oracle: a direct transcription of the reference's hot loop.

The reference ships with essentially no tests (SURVEY.md §4); this module is
the substitute ground truth the JAX renderer is validated against. It
replicates the semantics of ``render`` (src/lib.rs:747-838), ``Runtime::merge``
(src/lib.rs:708-738) and ``colorize`` (src/lib.rs:841-904) point-for-point,
including:

- the 1000-iteration warm-up discarded before binning (src/lib.rs:749-752),
- out-of-bounds points still updating ``previous_point`` (src/lib.rs:789-795),
- the strict ``z2 > zbuf`` test with the -1.0 sentinel (src/lib.rs:818-833),
- saturating float->u16 casts in the tone map (Rust ``as`` semantics).

It is deliberately slow (pure Python inner loop over iterations) — use small
configs.
"""

from __future__ import annotations

import numpy as np

from .config import Config, RenderKind
from .ops.projection import camera_params


def oracle_trajectory(config: Config, p0: np.ndarray, steps: int, dtype=np.float32) -> np.ndarray:
    """Iterate the raw map ``steps`` times from ``p0``; returns (steps+1, 3)."""
    p = np.asarray(p0, dtype)
    out = np.empty((steps + 1, 3), dtype)
    out[0] = p
    for k in range(steps):
        p = config.attractor.step_numpy(p)
        out[k + 1] = p
    return out


def oracle_points(config: Config, p0: np.ndarray, steps: int, dtype=np.float32):
    """Run warm-up + ``steps`` iterations of one lane; emit the binned stream.

    Returns dict of arrays (steps,): ``fi, fj, z2, value, inbounds, flat``
    exactly as the hot loop computes them (src/lib.rs:769-837). ``flat`` is
    ``j * width + i`` for in-bounds points, -1 otherwise.
    """
    dt = np.dtype(dtype).type
    cam = camera_params(config.view, config.angle, config.width, config.height)
    m = np.asarray(cam.rotation_matrix, dtype)
    cos_v, sin_v = dt(cam.cos_angle), dt(cam.sin_angle)
    ccx, ccy, ccz = (dt(v) for v in cam.center_camera)
    width, height = dt(config.width), dt(config.height)
    width_scaled, mid = dt(cam.width_scaled), dt(cam.scale_adjusted_mid)

    p = np.asarray(p0, dtype)
    for _ in range(config.warmup):
        p = config.attractor.step_numpy(p)
    prev = p
    cur = p

    fi = np.empty(steps, dtype)
    fj = np.empty(steps, dtype)
    z2a = np.empty(steps, dtype)
    val = np.empty(steps, dtype)
    inb = np.empty(steps, bool)
    flat = np.full(steps, -1, np.int64)

    for k in range(steps):
        cur = config.attractor.step_numpy(cur)
        s = np.array(
            [
                m[0, 0] * cur[0] + m[0, 1] * cur[1] + m[0, 2] * cur[2],
                m[1, 0] * cur[0] + m[1, 1] * cur[1] + m[1, 2] * cur[2],
                m[2, 0] * cur[0] + m[2, 1] * cur[1] + m[2, 2] * cur[2],
            ],
            dtype,
        )
        x2 = (s[0] + ccx) * cos_v + (s[2] + ccy) * sin_v
        z2 = (s[0] + ccx) * sin_v - (s[2] + ccy) * cos_v
        i = (mid - x2) * width_scaled
        j = height / dt(2.0) - (s[1] + ccz) * width_scaled
        # reference form (src/lib.rs:789): skip iff i>=W or j>=H or i<0 or
        # j<0 — NaN fails all four and passes; Rust's saturating `as u32`
        # then bins it at pixel (0, 0) (escaped-orbit behavior)
        ok = not bool((i >= width) | (j >= height) | (i < 0.0) | (j < 0.0))
        fi[k], fj[k], z2a[k], inb[k] = i, j, z2, ok
        delta = cur - prev
        val[k] = config.color_transform.numpy(delta, s, config.view)
        if ok:
            ii = 0 if np.isnan(i) else int(i)
            jj = 0 if np.isnan(j) else int(j)
            flat[k] = jj * config.width + ii
        prev = cur
    return {"fi": fi, "fj": fj, "z2": z2a, "value": val, "inbounds": inb, "flat": flat}


def oracle_bin(width: int, height: int, flat, z2, value, count=None, steps=None, zbuf=None):
    """Sequentially bin a point stream with the reference's exact semantics.

    ``flat`` entries < 0 are out-of-bounds points (skipped). Accumulates into
    (and returns) ``count`` (u64), ``steps`` (f32), ``zbuf`` (f32) planes.
    """
    npix = width * height
    if count is None:
        count = np.zeros(npix, np.uint64)
        steps = np.zeros(npix, np.float32)
        zbuf = np.full(npix, -1.0, np.float32)
    for k in range(len(flat)):
        f = flat[k]
        if f < 0:
            continue
        count[f] += 1
        z = np.float32(z2[k])
        if z > zbuf[f]:  # strict: ties keep the earlier value (src/lib.rs:821)
            steps[f] = np.float32(value[k])
            zbuf[f] = z
    return count, steps, zbuf


def oracle_render(config: Config, seeds: np.ndarray, steps_per_lane: int, dtype=np.float32):
    """Render ``seeds.shape[0]`` lanes sequentially (merge-equivalent).

    ``seeds`` are pre-warm-up initial points, shape (L, 3) — the reference
    seeds each work unit with ``rng.random::<Vec3>() * 0.1`` (src/lib.rs:748).
    Returns (count u64, steps f32, zbuf f32) reshaped to (H, W).
    """
    seeds = np.atleast_2d(np.asarray(seeds, dtype))
    count = steps = zbuf = None
    for lane in range(seeds.shape[0]):
        pts = oracle_points(config, seeds[lane], steps_per_lane, dtype)
        count, steps, zbuf = oracle_bin(
            config.width, config.height, pts["flat"], pts["z2"], pts["value"], count, steps, zbuf
        )
    shape = (config.height, config.width)
    return count.reshape(shape), steps.reshape(shape), zbuf.reshape(shape)


def _saturate_u16(x: np.ndarray) -> np.ndarray:
    """Rust ``as u16`` float cast: NaN -> 0, clamp to [0, 65535], truncate."""
    x = np.nan_to_num(x, nan=0.0, posinf=65535.0, neginf=0.0)
    return np.clip(x, 0.0, 65535.0).astype(np.uint16)


def oracle_colorize(config: Config, count: np.ndarray, steps: np.ndarray, zbuf: np.ndarray):
    """Tone-map to (H, W, 4) uint16 RGBA (reference: src/lib.rs:841-904)."""
    if config.render == RenderKind.GAS:
        bk = config.colors.brightness
        rgb = config.colors.palette.interpolate_numpy(steps.astype(np.float64))  # (H, W, 3)
        cmax = np.float64(count.max())
        # log base (max+1); log1p(0)/log1p(0) = NaN -> 0 via saturate
        with np.errstate(divide="ignore", invalid="ignore"):
            factor = np.log(count.astype(np.float64) + 1.0) / np.log(cmax + 1.0)
        channels = (rgb * factor[..., None] + bk.offset) * bk.factor * 65535.0
        if config.transparent:
            alpha = _saturate_u16(factor * 65535.0)
        else:
            alpha = np.full(count.shape, 65535, np.uint16)
        return np.concatenate([_saturate_u16(channels), alpha[..., None]], axis=-1)

    # Depth (src/lib.rs:875-899): min/max over zbuf ignoring the -1 sentinel;
    # fold starts at (0.0, f32::MAX) so max is floored at 0.
    valid = zbuf != -1.0
    zmax = np.float32(0.0)
    zmin = np.float32(np.finfo(np.float32).max)
    if valid.any():
        zmax = max(zmax, zbuf[valid].max())
        zmin = min(zmin, zbuf[valid].min())
    diff = zmax - zmin
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(valid, (zbuf - zmin) / diff, np.float32(0.0))
    gray = _saturate_u16(z * np.float32(65535.0))  # f32 math like the reference
    alpha = np.full(zbuf.shape, 65535, np.uint16)
    return np.stack([gray, gray, gray, alpha], axis=-1)
