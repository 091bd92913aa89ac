"""The render engine: map iteration, binning, colorize, and the parallel /
sequence drivers.

Device architecture (contrast with the reference's thread pool, src/lib.rs:906-1082):

- ``lanes`` independent trajectories advance together as one vectorized
  step; a ``lax.scan`` walks ``chunk_steps`` map iterations emitting a point
  chunk; the chunk is binned device-side; an outer scan walks chunks. One
  ``jit`` = one fused device program per batch of chunks.
- Work splitting ("jobs per thread", src/lib.rs:1058) is replaced by the
  lanes x steps grid; merging partial canvases (src/lib.rs:1068-1076) is only
  needed across devices, where it is a collective (see ``parallel.mesh``).
- Warm-up (1000 discarded iterations, src/lib.rs:749-752) runs once per lane.
"""

from __future__ import annotations

import functools
import time
from typing import Iterator, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .config import BinStrategy, Config, RenderKind
from .models.attractors import as_xyz_step
from .models.transforms import as_xyz_transform
from .ops import binning
from .ops.colorize import colorize_planes, state_planes
from .ops.projection import camera_params, project, rotate_xyz
from .runtime import RenderState

_KERNEL_CACHE: dict = {}
# chunks per device dispatch: one dispatch runs a scan over this many chunks,
# so bigger groups mean fewer host round trips; smaller groups report
# progress (and previews) more often. Not yet measured on the H100
# (ROADMAP 3.2). The env knob exists for end-to-end A/B runs; it must be set
# before import.
DISPATCH_GROUP = int(__import__("os").environ.get("SAR_DISPATCH_GROUP", "64"))
# compiled vmapped sequence-batch programs (see render_sequence_batched)
_BATCHED_CACHE: dict = {}
# compiled shared-orbit sequence programs (see render_sequence_shared)
_SHARED_SEQ_CACHE: dict = {}


def _dtype(config: Config):
    dt = jnp.dtype(config.dtype)
    if dt == jnp.float64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "Config.dtype='float64' needs jax_enable_x64 "
            "(set JAX_ENABLE_X64=1 or jax.config.update('jax_enable_x64', True)); "
            "note f64 is slower than f32 — the f32 default renders the "
            "same invariant measure (see README precision note)"
        )
    return dt


def seed_key(config: Config, key=None):
    """Explicit key > config.seed > nondeterministic (reference uses an
    OS-seeded SmallRng per thread, src/lib.rs:656)."""
    if key is not None:
        return key
    if config.seed is not None:
        return jax.random.PRNGKey(config.seed)
    return jax.random.PRNGKey(np.random.SeedSequence().entropy % (2**63))


def progressive_key(config: Config, state: RenderState):
    """Content-derived continuation key for seeded progressive renders.

    Distinct trajectories per progressive call: the nonce derives from the
    accumulated content, so 'seed=N' reproducibility depends only on the
    starting state — never on how many renders any other state saw earlier
    in the process. Shared by :func:`render` and the mesh resume path
    (parallel.mesh.render_sharded) so a checkpoint continues with the same
    key either way.
    """
    if state.count is not None:
        nonce = int(jax.device_get(state.count.sum())) & 0xFFFFFFFF
    else:
        # DEPTH carries no count; hash the z-plane bits instead. Still
        # purely content-derived: the same starting state gets the same
        # continuation regardless of call order or process restarts (a
        # global call counter broke exactly that). Caveat: DEPTH
        # accumulation is idempotent (pure max), so a progressive call
        # that updates NO pixel replays the same key next call — but
        # such a call made zero progress anyway, so the fixed point is
        # honest.
        bits = lax.bitcast_convert_type(state.zbuf, jnp.uint32)
        nonce = int(jax.device_get(jnp.sum(bits, dtype=jnp.uint32))) & 0xFFFFFFFF
    return jax.random.fold_in(seed_key(config), nonce)


def plan_schedule(config: Config) -> tuple[int, int, int]:
    """Resolve (lanes, chunk_steps, nchunks) so that
    lanes * chunk_steps * nchunks ~= iterations.

    Like the reference's integer work split (src/lib.rs:1058), the executed
    count may differ slightly from the request; set ``lanes``/``chunk_steps``
    to divisors for exact counts.

    An explicitly pinned ``Config.chunk_steps`` is executed EXACTLY (the
    chunk count rounds up, so the executed total may exceed the request by
    up to one lanes x chunk_steps block).

    Auto chunks are EVENED: nchunks is fixed first (ceil at the buffer-sized
    chunk), then the chunk length is re-derived from it. With big chunk
    buffers at small lane counts (resolved_chunk_steps round-4 fix), naive
    round-at-the-cap scheduling could execute up to ~25% off the request
    (1e7 at 512 lanes: 2 chunks of 8192 steps = 8.4M); evening keeps the
    executed count within one lane-step round while ceil keeps every chunk
    within the point-buffer size.
    """
    lanes = config.resolved_lanes()
    target_steps = max(1, round(config.iterations / lanes))
    pinned = config.chunk_steps is not None
    chunk = config.resolved_chunk_steps()
    if not pinned:
        chunk = min(chunk, target_steps)
    nchunks = max(1, -(-target_steps // chunk))
    if not pinned:
        chunk = max(1, round(target_steps / nchunks))
    return lanes, chunk, nchunks


def _step_fn(config: Config, cam, strategy: BinStrategy):
    """One map iteration for the whole lane batch -> emitted point chunk row.

    Body of the innermost scan; replicates src/lib.rs:769-837 (see
    ops.projection for the quirk-preserving math).

    The carry keeps lane coordinates as six separate (lanes,) arrays
    (x, y, z, px, py, pz) rather than two (lanes, 3) arrays, so every
    elementwise op runs over contiguous lanes with no 3-wide minor
    dimension. Use :func:`_split_xyz` / :func:`_join_xyz` at the chunk
    boundary.
    """
    step_xyz = as_xyz_step(config.attractor)
    transform = as_xyz_transform(config.color_transform)
    view = config.view
    W, H = config.width, config.height
    npix = W * H

    def step(carry, _):
        x, y, z, px, py, pz, age, cos_v, sin_v = carry
        nx, ny, nz = step_xyz(x, y, z)
        sx, sy, sz = rotate_xyz(cam, nx, ny, nz, jnp)
        fi, fj, z2 = project(cam, sx, sy, sz, cos_v, sin_v, jnp)
        # clamp at 1 so a lane never overflows int32 on huge renders;
        # negative while a reseeded lane re-warms (emit when > 0)
        age = jnp.minimum(age + 1, jnp.int32(1))
        val = transform(nx - px, ny - py, nz - pz, sx, sy, sz, view)
        emitted = _finish_emit(strategy, npix, W, H, fi, fj, z2, val, age > 0)
        # previous point advances even when out of bounds (src/lib.rs:789-795)
        return (nx, ny, nz, nx, ny, nz, age, cos_v, sin_v), emitted

    return step


def _finish_emit(strategy: BinStrategy, npix: int, W: int, H: int,
                 fi, fj, z2, val, gate):
    """Pixel-coordinate bounds check + strategy packing for one point batch.

    Shared tail of :func:`_step_fn` (fused map step) and
    :func:`_project_emit` (the shared-orbit sequence path), so both emit the
    bit-identical ``(flat, payload...)`` stream for the same inputs.

    ``gate`` is the emission gate (``age > 0``; ``None`` means all-true —
    reseed-free shared orbits skip materializing the constant).
    """
    dt = fi.dtype
    # Replicate the reference bounds check exactly (src/lib.rs:789): a
    # point is SKIPPED iff i>=W or j>=H or i<0 or j<0. NaN coordinates
    # (escaped orbits: inf -> NaN after a few steps) fail all four
    # comparisons, PASS the check, and the saturating `as u32` cast bins
    # them at pixel (0,0) (src/lib.rs:799-812) — inflating `max` there
    # and dimming the tone map. That is part of the reference's output
    # for escaping presets (solar-sail), so it is preserved.
    zero = jnp.asarray(0.0, dt)
    oob = (fi >= W) | (fj >= H) | (fi < zero) | (fj < zero)
    inb = ~oob if gate is None else ~oob & gate
    ii = jnp.nan_to_num(fi, nan=0.0).astype(jnp.int32)
    jj = jnp.nan_to_num(fj, nan=0.0).astype(jnp.int32)
    flat = jnp.where(inb, jj * W + ii, jnp.int32(npix))
    # NaN z never wins the z-test (NaN > zbuf is false, src/lib.rs:821);
    # -inf is the scatter-max-safe equivalent
    z2 = jnp.where(jnp.isnan(z2), -jnp.inf, z2)
    if strategy.planes_kind() == BinStrategy.PACKED:  # PACKED and KERNEL
        return (flat, binning.pack_zv(z2.astype(jnp.float32), val.astype(jnp.float32)))
    if strategy.planes_kind() == BinStrategy.DEPTH:  # DEPTH and DEPTH_KERNEL
        return (flat, z2.astype(jnp.float32))
    return (flat, z2.astype(jnp.float32), val.astype(jnp.float32))


def _step_fn_shared(config: Config, cam, strategy: BinStrategy):
    """Camera-angle-independent half of :func:`_step_fn`.

    For a rotation sequence only :func:`ops.projection.project` depends on
    the per-frame angle — the attractor step, the view rotation, the color
    transform value, and even the vertical pixel coordinate ``fj`` (the
    angle rotates about the vertical screen axis, src/lib.rs:776-786) are
    frame-invariant. This step emits exactly those invariants per point:

        xc  = sx + cc.x          (the angle-rotation operands of project())
        zc  = sz + cc.y
        fj  = H/2 - (sy + cc.z) * width*scale
        val = color transform value (omitted for DEPTH-kind strategies)
        gate (only when ``config.reseed_lanes``: re-warming lanes emit-gate)

    :func:`_project_emit` turns them into any frame's ``(flat, payload)``
    stream with four multiplies — bit-identical to the fused step's output
    for the same orbit (pinned in tests/test_sequence_shared.py).
    """
    step_xyz = as_xyz_step(config.attractor)
    transform = as_xyz_transform(config.color_transform)
    view = config.view
    W, H = config.width, config.height
    emit_val = strategy.planes_kind() != BinStrategy.DEPTH
    emit_gate = bool(config.reseed_lanes)

    def step(carry, _):
        x, y, z, px, py, pz, age = carry
        nx, ny, nz = step_xyz(x, y, z)
        sx, sy, sz = rotate_xyz(cam, nx, ny, nz, jnp)
        dt = sx.dtype
        age = jnp.minimum(age + 1, jnp.int32(1))
        xc = sx + jnp.asarray(cam.center_camera[0], dt)
        zc = sz + jnp.asarray(cam.center_camera[1], dt)  # cc.y<->z quirk
        fj = jnp.asarray(cam.height / 2.0, dt) - (
            sy + jnp.asarray(cam.center_camera[2], dt)
        ) * jnp.asarray(cam.width_scaled, dt)
        emitted = [xc, zc, fj]
        if emit_val:
            emitted.append(transform(nx - px, ny - py, nz - pz, sx, sy, sz, view))
        if emit_gate:
            emitted.append(age > 0)
        return (nx, ny, nz, nx, ny, nz, age), tuple(emitted)

    return step


def _project_emit(config: Config, cam, strategy: BinStrategy,
                  cos_v, sin_v, emitted):
    """Finish one frame's emission from a shared-orbit point chunk.

    Applies the only angle-dependent math of src/lib.rs:776-786 —
    ``x2 = xc cos + zc sin``, ``z2 = xc sin - zc cos``, the horizontal pixel
    coordinate — then the shared :func:`_finish_emit` tail. The expressions
    match :func:`ops.projection.project` term for term so the resulting
    stream is bit-identical to the fused single-frame path's.
    """
    W, H = config.width, config.height
    npix = W * H
    emit_val = strategy.planes_kind() != BinStrategy.DEPTH
    xc, zc, fj = emitted[:3]
    val = emitted[3] if emit_val else jnp.zeros((), xc.dtype)
    gate = emitted[-1] if config.reseed_lanes else None
    dt = xc.dtype
    x2 = xc * cos_v + zc * sin_v
    z2 = xc * sin_v - zc * cos_v
    fi = (jnp.asarray(cam.scale_adjusted_mid, dt) - x2) * jnp.asarray(cam.width_scaled, dt)
    return _finish_emit(strategy, npix, W, H, fi, fj, z2, val, gate)


def _split_xyz(p):
    """(lanes, 3) -> three (lanes,) component arrays (hot-path layout)."""
    return p[..., 0], p[..., 1], p[..., 2]


def _join_xyz(x, y, z):
    return jnp.stack([x, y, z], axis=-1)


def _reseed_dead_lanes(config: Config, key, cur, prev, age, dt):
    """Opt-in lane resurrection (``Config.reseed_lanes``).

    Some coefficient sets have escaping basins: ~40% of solar-sail seed points
    diverge to infinity within ~32 steps *in the reference's own f64 math*.
    In the reference those work units first skip points while coordinates are
    +/-inf, then — once arithmetic turns them NaN — bin every remaining
    iteration at pixel (0,0) (NaN passes the bounds check, src/lib.rs:789,
    and saturating casts map it to 0), inflating the brightness normalizer.
    With reseeding on, escaped lanes instead restart from a fresh seed and
    re-warm before emitting — every iteration contributes a real sample of
    the invariant measure. (This intentionally diverges from reference
    behavior; leave it off for output parity.)
    """
    key, sub = jax.random.split(key)
    bad = ~jnp.isfinite(cur).all(axis=-1) | (jnp.abs(cur).max(axis=-1) > jnp.asarray(1e3, dt))
    fresh = jax.random.uniform(sub, cur.shape, dtype=dt) * jnp.asarray(0.1, dt)
    cur = jnp.where(bad[:, None], fresh, cur)
    prev = jnp.where(bad[:, None], fresh, prev)
    age = jnp.where(bad, jnp.int32(-config.warmup), age)
    return key, cur, prev, age


def _bin_fn(config: Config, strategy: BinStrategy, *, vmapped: bool = False):
    """planes, emitted -> planes for one chunk, per strategy. All strategies
    operate on the standard flattened (npix,) planes; the *_KERNEL ones run
    the sort-bin pipeline (:mod:`ops.kernel_binning`) instead of one
    scatter update per point (:mod:`ops.binning`).

    ``vmapped=True`` (the batched sequence paths) disables the runtime
    pixel-0 flood gate: a batched ``lax.cond`` lowers to ``select_n`` and
    executes BOTH the evicted and plain pipelines — double the dominant
    binning cost — so vmapped callers always-evict instead (bit-exact,
    see :func:`ops.kernel_binning.bin_chunk_kernel`)."""
    if strategy in (BinStrategy.KERNEL, BinStrategy.EXACT_KERNEL,
                    BinStrategy.EXACT16_KERNEL, BinStrategy.DEPTH_KERNEL):
        from .ops import kernel_binning as kb

        if (strategy is BinStrategy.EXACT16_KERNEL
                and config.exact16_ties == "earliest"
                and not jax.config.jax_enable_x64):
            import warnings

            # bit-identical fallback, but a stable 3-operand sort instead of
            # the u64 2-operand one — surface it at the library level, not
            # just the CLI (which enables x64 itself)
            warnings.warn(
                "exact16_ties='earliest' without jax_enable_x64 uses the "
                "stable-sort fallback (3 operands, bit-identical). Enable "
                "x64 (jax.config.update('jax_enable_x64', True) before "
                "tracing) for the u64 2-operand sort.",
                stacklevel=3,
            )
        fn = {
            BinStrategy.KERNEL: kb.bin_chunk_kernel,
            BinStrategy.EXACT_KERNEL: kb.bin_chunk_kernel_exact,
            BinStrategy.EXACT16_KERNEL: kb.bin_chunk_kernel_exact16,
            BinStrategy.DEPTH_KERNEL: kb.bin_chunk_kernel_depth,
        }[strategy]
        kwargs = dict(npix=config.width * config.height)
        if config.kernel_section is not None:
            kwargs["section"] = int(config.kernel_section)
        if strategy is BinStrategy.EXACT16_KERNEL:
            kwargs["ties"] = config.exact16_ties
        if vmapped and strategy in (BinStrategy.KERNEL, BinStrategy.DEPTH_KERNEL):
            kwargs["flood_gate"] = False

        def bin_planes(planes, emitted):
            return fn(*planes, *emitted, **kwargs)

        return bin_planes
    if strategy == BinStrategy.PACKED:
        return lambda planes, emitted: binning.bin_chunk_packed(*planes, *emitted)
    if strategy == BinStrategy.DEPTH:
        return lambda planes, emitted: binning.bin_chunk_depth(*planes, *emitted)
    return lambda planes, emitted: binning.bin_chunk_exact(*planes, *emitted)


def _state_to_planes(state: RenderState, strategy: BinStrategy):
    """Flatten a state into the accumulation-plane tuple for ``strategy``."""
    kind = strategy.planes_kind()
    if kind == BinStrategy.PACKED:
        return (state.count.reshape(-1), state.packed.reshape(-1))
    if kind == BinStrategy.DEPTH:
        return (state.zbuf.reshape(-1),)
    return (state.count.reshape(-1), state.steps.reshape(-1), state.zbuf.reshape(-1))


def _planes_to_state(planes, strategy: BinStrategy, shape, copy: bool = False):
    """Inverse of :func:`_state_to_planes`."""
    c = (lambda x: jnp.array(x, copy=True)) if copy else (lambda x: x)
    p = [c(pl).reshape(shape) for pl in planes]
    kind = strategy.planes_kind()
    if kind == BinStrategy.PACKED:
        return RenderState(count=p[0], packed=p[1])
    if kind == BinStrategy.DEPTH:
        return RenderState(zbuf=p[0])
    return RenderState(count=p[0], steps=p[1], zbuf=p[2])


def _seed_warm(config: Config, lanes: int, dt, key):
    """Seed U[0,1)^3 * 0.1 then warm up (src/lib.rs:748-752) — the shared
    trajectory bootstrap of _build_kernels.init and _canvas_body.

    unroll=8 like the map scan (_chunk_update): a loop step's fixed
    overhead can outweigh the warm-up's per-step math. Unrolling changes no
    math — the same ops run in the same order per lane (golden tests pin
    exact values)."""
    step_xyz = as_xyz_step(config.attractor)
    p0 = jax.random.uniform(key, (lanes, 3), dtype=dt) * jnp.asarray(0.1, dt)
    warmed = lax.fori_loop(0, config.warmup, lambda i, p: step_xyz(*p),
                           _split_xyz(p0), unroll=8)
    return _join_xyz(*warmed)


def _chunk_update(config: Config, step, bin_planes, chunk_steps: int, dt,
                  planes, cur, prev, age, rkey, cos_v, sin_v):
    """Advance one chunk: optional reseed -> scanned map steps -> bin.

    The single shared chunk body behind _build_kernels.run and
    _canvas_body (a fix to one used to silently miss the other — the
    vmapped flood-gate repair had to be threaded through both by hand).
    unroll=8: 8 map steps per loop iteration amortize the loop's per-step
    fixed overhead (not yet re-measured on the H100, ROADMAP 1.4).
    """
    if config.reseed_lanes:
        rkey, cur, prev, age = _reseed_dead_lanes(config, rkey, cur, prev, age, dt)
    (x, y, z, px, py, pz, age, _, _), emitted = lax.scan(
        step, (*_split_xyz(cur), *_split_xyz(prev), age, cos_v, sin_v),
        None, length=chunk_steps, unroll=8,
    )
    cur, prev = _join_xyz(x, y, z), _join_xyz(px, py, pz)
    planes = bin_planes(planes, tuple(e.reshape(-1) for e in emitted))
    return planes, cur, prev, age, rkey


def _build_kernels(config: Config, strategy: BinStrategy, nchunks: int):
    """Compile (init, run) for a config; cached on the angle-free fingerprint
    (the camera angle is a traced cos/sin pair so sequences don't recompile)."""
    lanes, chunk_steps, _ = plan_schedule(config)
    # angle is traced and iteration count only picks how often kernels run,
    # so neither belongs in the compile cache key; lanes/chunk_steps are
    # pinned to their *resolved* values so auto-scheduled configs and
    # precompile()'s explicitly-pinned warm config hash identically
    key = (
        config.replace(
            angle=0.0, iterations=1, lanes=lanes, chunk_steps=chunk_steps
        ).fingerprint(),
        strategy.value,
        nchunks,
    )
    hit = _KERNEL_CACHE.get(key)
    if hit is not None:
        return hit
    cam = camera_params(config.view, 0.0, config.width, config.height)
    dt = _dtype(config)
    step = _step_fn(config, cam, strategy)

    @jax.jit
    def init(key):
        return _seed_warm(config, lanes, dt, key)

    bin_planes = _bin_fn(config, strategy)

    def chunk(carry, _):
        planes, cur, prev, age, rkey, cos_v, sin_v = carry
        planes, cur, prev, age, rkey = _chunk_update(
            config, step, bin_planes, chunk_steps, dt,
            planes, cur, prev, age, rkey, cos_v, sin_v,
        )
        return (planes, cur, prev, age, rkey, cos_v, sin_v), None

    @functools.partial(jax.jit, donate_argnums=0)
    def run(planes, cur, prev, age, rkey, cos_v, sin_v):
        carry, _ = lax.scan(
            chunk, (planes, cur, prev, age, rkey, cos_v, sin_v), None, length=nchunks
        )
        return carry[:5]

    _KERNEL_CACHE[key] = (init, run)
    return init, run


def precompile(config: Config, strategy: Optional[BinStrategy] = None) -> RenderState:
    """Build every kernel variant a :func:`render` call will need, so timed
    runs measure execution only (a cold compile takes seconds).

    Returns the warm-up's final state. Downstream consumers (colorize /
    export conversion) should be warmed WITH this state, not a state from a
    differently-shaped render: the last warm dispatch is the same remainder
    program a full render ends with, so the returned planes carry the same
    device layout — warming with a different producer compiles the consumer
    for another layout and the first real call silently re-JITs.

    An explicit ``strategy`` pins ``config.bin_strategy`` for the warm-up
    (and only helps if the real renders use the same pinned config):
    without the pin, render()'s own resolution won the strategy choice and
    the parameter silently warmed the RESOLVED variant, never the
    requested one.
    """
    if strategy is not None and config.bin_strategy is not strategy:
        config = config.replace(bin_strategy=strategy)
    else:
        strategy = config.resolved_bin_strategy()
    lanes, chunk_steps, nchunks = plan_schedule(config)
    # warm exactly the kernel variants render() will dispatch: the full
    # dispatch group plus the remainder group; pin the resolved schedule so
    # the warm run hits the same cache keys
    g = DISPATCH_GROUP
    warm_chunks = nchunks if nchunks <= g else g + (nchunks % g or g)
    warm = config.replace(
        iterations=lanes * chunk_steps * warm_chunks,
        lanes=lanes,
        chunk_steps=chunk_steps,
        silent=True,
    )
    state = render(warm, RenderState.create(config, strategy), jax.random.PRNGKey(0))
    return jax.block_until_ready(state)


def render(
    config: Config,
    state: Optional[RenderState] = None,
    key=None,
    *,
    angle: Optional[float] = None,
    on_progress=None,
) -> RenderState:
    """Accumulate ``config.iterations`` map iterations into ``state``.

    Like the reference's ``render`` (src/lib.rs:747): call repeatedly on the
    returned state for progressive refinement; each call reseeds its
    trajectories (for seeded configs, successive progressive calls fold a
    per-call nonce into the key so refinement adds new samples — the
    reference draws fresh OS entropy per call, src/lib.rs:656,748). ``angle``
    (radians) overrides ``config.angle`` without recompiling.

    The input ``state`` remains valid (only internal working copies are
    donated between chunk dispatches); prefer the returned state.

    ``on_progress(done_chunks, total_chunks, partial_state)`` is invoked
    after each dispatch group — the hook for progressive previews of the
    ever-improving image (the reference documents the property at
    src/lib.rs:742-744 but gives no way to observe it mid-render).
    """
    progressive = state is not None
    resolved = config.resolved_bin_strategy()
    if state is None:
        strategy = resolved
        state = RenderState.create(config, strategy)
    else:
        if state.shape != (config.height, config.width):
            raise ValueError(
                f"state canvas {state.shape} does not match config "
                f"{(config.height, config.width)}; use state.set_width_height() "
                "for a reset state of the new size (the reference's resize "
                "likewise discards the accumulation, src/lib.rs:666-675)"
            )
        # plane-compatible: e.g. a PACKED-plane state resumes through the
        # KERNEL accumulation path (they share layout and semantics)
        strategy = resolved if resolved.planes_kind() == state.strategy else state.strategy
    if config.iterations < 1:
        return state
    if key is None and progressive and config.seed is not None:
        key = progressive_key(config, state)

    lanes, chunk_steps, nchunks = plan_schedule(config)
    # split chunks over a few dispatches so long renders report progress;
    # only two kernel variants compile per schedule (the DISPATCH_GROUP
    # group and the remainder group), which precompile() warms exactly
    inner = min(nchunks, DISPATCH_GROUP)
    outer_full, rem = divmod(nchunks, inner)

    a = config.angle if angle is None else angle
    dt = _dtype(config)
    cos_v = jnp.asarray(np.cos(a), dt)
    sin_v = jnp.asarray(np.sin(a), dt)

    base_key = seed_key(config, key)
    init, _ = _build_kernels(config, strategy, inner)
    cur = init(base_key)
    prev = cur
    age = jnp.zeros((cur.shape[0],), jnp.int32)
    rkey = jax.random.fold_in(base_key, 0x5EED)

    shape = state.shape
    done = 0

    def dispatch(n, planes, cur, prev, age, rkey):
        _, run = _build_kernels(config, strategy, n)
        return run(planes, cur, prev, age, rkey, cos_v, sin_v)

    planes = _state_to_planes(state, strategy)

    def _partial_state(copy: bool = False):
        # progress callbacks may retain the state past the next dispatch,
        # which donates (invalidates) the working planes — hand them a copy
        return _planes_to_state(planes, strategy, shape, copy=copy)

    if not config.silent:
        # the reference announces each worker thread as it picks up the job
        # (src/lib.rs:953-954); the SPMD analog is one announcement for the
        # whole lane batch — every lane starts the same program together
        print(f"Rendering started on device ({lanes} lanes).")

    t0 = time.perf_counter()
    for _ in range(outer_full):
        planes, cur, prev, age, rkey = dispatch(inner, planes, cur, prev, age, rkey)
        done += inner
        if not config.silent:
            print(f"Iteration complete, {nchunks - done} left to go.")
        if on_progress is not None:
            on_progress(done, nchunks, _partial_state(copy=True))
    if rem:
        # one remainder-sized dispatch instead of `rem` single-chunk ones:
        # every dispatch is one more host round trip
        planes, cur, prev, age, rkey = dispatch(rem, planes, cur, prev, age, rkey)
        done += rem
    if on_progress is not None and rem:
        on_progress(done, nchunks, _partial_state(copy=True))
    if not config.silent:
        # dispatches are async — sync before timing or the rate is fiction
        jax.block_until_ready(planes)
        executed = lanes * chunk_steps * nchunks
        dtime = time.perf_counter() - t0
        print(
            f"Rendered {executed:.3e} iterations in {dtime:.2f}s "
            f"({executed / max(dtime, 1e-9):.3e} iters/s)."
        )

    return _partial_state()


_COLORIZE_CACHE: dict = {}


def colorize(config: Config, state: RenderState):
    """Tone-map an accumulated state to a (H, W, 4) uint16 RGBA device array
    (reference: src/lib.rs:841-904)."""
    key = (
        config.colors.palette.fingerprint(),
        config.colors.brightness.offset,
        config.colors.brightness.factor,
        config.render.value,
        config.transparent,
        state.strategy.value,
    )
    fn = _COLORIZE_CACHE.get(key)
    if fn is None:

        @jax.jit
        def fn(st):
            return colorize_planes(config, *state_planes(st))

        _COLORIZE_CACHE[key] = fn
    return fn(state)


_BANDED_CACHE: dict = {}
# learned lit-bbox + fill per deliverable (colorize_convert_fetch crop path)
_CROP_CACHE: dict = {}

# crop snap quanta: coarse enough that run-to-run bbox jitter (different
# seeds move the support by a few pixels) reuses the same compiled band
# shapes, plus one quantum of margin absorbs progressive-render growth
_CROP_ROW_SNAP = 8
_CROP_COL_SNAP = 64
# past this lit fraction a crop saves too few bytes to be worth distinct
# band-program shapes
_CROP_MAX_FRAC = 0.95


def _largest_divisor_at_most(n: int, k: int) -> int:
    k = max(1, min(int(k), int(n)))
    while n % k:
        k -= 1
    return k


def _crop_window(bbox, h: int, w: int):
    """Snap a learned lit bbox to the crop quanta with one quantum of margin.
    Returns None (deliver the full canvas) for empty, degenerate, or
    nearly-full boxes."""
    r_lo, r_hi, c_lo, c_hi = (int(v) for v in bbox)
    if r_hi <= r_lo or c_hi <= c_lo:
        return None
    r0 = max(0, (r_lo // _CROP_ROW_SNAP - 1) * _CROP_ROW_SNAP)
    r1 = min(h, -(-r_hi // _CROP_ROW_SNAP) * _CROP_ROW_SNAP + _CROP_ROW_SNAP)
    c0 = max(0, (c_lo // _CROP_COL_SNAP - 1) * _CROP_COL_SNAP)
    c1 = min(w, -(-c_hi // _CROP_COL_SNAP) * _CROP_COL_SNAP + _CROP_COL_SNAP)
    if r1 <= r0 or c1 <= c0:
        # a bbox beyond the canvas inverts under clamping (possible only
        # via a corrupted cache — riders are canvas-bounded); full fetch
        return None
    if (r1 - r0) * (c1 - c0) >= _CROP_MAX_FRAC * h * w:
        return None
    return r0, r1, c0, c1


def _wire_channels(config: Config, transparent: bool) -> tuple[int, int]:
    """``(wire, full)`` channel counts for a deliverable fetch.

    DEPTH tone maps every pixel to ``(g, g, g, 65535)`` (ops/colorize.py —
    reference src/lib.rs:875-899 writes the same gray to R/G/B and a
    constant opaque alpha), so only ONE channel needs to be copied to the
    host (3x fewer bytes); the host replicates the gray into the color
    channels and fills alpha with the dtype max — exactly what the device
    conversion produces for 65535 at either bit depth (the multiply-shift
    is pinned for all 65536 inputs in tests/test_export.py). GAS opaque
    already drops the constant alpha on device (wire 3); GAS transparent
    has 4 live channels.
    """
    full = 4 if transparent else 3
    wire = 1 if config.render == RenderKind.DEPTH else full
    return wire, full


def _slice_wire(img, wire: int, full: int):
    """Device-side half of the wire-channel reduction: keep only the live
    channels of a converted deliverable (channel 0 carries the DEPTH gray).
    Identity when every channel is live."""
    return img if wire == full else img[..., :wire]


def _expand_wire(arr: np.ndarray, wire: int, full: int) -> np.ndarray:
    """Host-side inverse of the wire-channel reduction: broadcast the gray
    channel into RGB and synthesize the constant alpha. Identity when the
    wire already carries every channel."""
    if wire == full:
        return arr
    out = np.empty((*arr.shape[:-1], full), arr.dtype)
    out[..., :3] = arr[..., :1]
    if full == 4:
        out[..., 3] = np.iinfo(arr.dtype).max
    return out


def _rider_bits(config, st, stats, transparent: bool, eight_bit: bool):
    """Traced helper: the (4 + 2*channels) uint32 delivery rider.

    ``[r_lo, r_hi, c_lo, c_hi, fill..., corner...]`` where the bbox is the
    lit row/col extent of the accumulation (count > 0, or zbuf != -1 for
    depth-only states — a superset of every pixel the tone map can light)
    EXCLUDING pixel (0, 0), ``fill`` is the converted output of an UNLIT
    pixel (a 1x1 unlit plane set through the identical colorize + convert
    path with the real stats), and ``corner`` is the converted output of
    pixel (0, 0) itself, from the real planes through the same path.

    Pixel (0, 0) is excluded because the reference's NaN quirk floods it
    on escaping presets (solar-sail: ~38% of all points — see
    ops/kernel_binning.py), pinning an otherwise-interior bbox to the
    origin; the host pastes ``corner`` back after the fill, which is a
    no-op for non-flood renders (an unlit corner's output IS the fill).
    Two any-reductions + two 1x1 tone maps: ~nothing next to a band's
    compute, and the constant fill + corner paste outside the bbox stay
    bit-exact by construction.
    """
    from .utils.export import convert_format_device

    if st.count is not None:
        mask = st.count > 0
    else:
        mask = st.zbuf != jnp.float32(-1.0)
    mask = mask.at[0, 0].set(False)
    h, w = mask.shape
    rows = jnp.any(mask, axis=1)
    cols = jnp.any(mask, axis=0)
    ri = jnp.arange(h, dtype=jnp.int32)
    ci = jnp.arange(w, dtype=jnp.int32)
    r_lo = jnp.min(jnp.where(rows, ri, jnp.int32(h)))
    r_hi = jnp.max(jnp.where(rows, ri, jnp.int32(-1))) + 1
    c_lo = jnp.min(jnp.where(cols, ci, jnp.int32(w)))
    c_hi = jnp.max(jnp.where(cols, ci, jnp.int32(-1))) + 1
    unlit = RenderState(
        count=None if st.count is None else jnp.zeros((1, 1), jnp.uint32),
        steps=None if st.steps is None else jnp.zeros((1, 1), jnp.float32),
        zbuf=None if st.zbuf is None else jnp.full((1, 1), -1.0, jnp.float32),
        packed=None if st.packed is None else jnp.zeros((1, 1), jnp.uint32),
    )
    corner = RenderState(*(None if p is None else p[:1, :1] for p in st))
    wire, full = _wire_channels(config, transparent)
    pixels = []
    for one in (unlit, corner):
        img = convert_format_device(
            colorize_planes(config, *state_planes(one), stats=stats),
            transparent, eight_bit)
        # fill/corner ride in WIRE channels — the host expands them with
        # the same _expand_wire rule it applies to the body
        pixels.append(_slice_wire(img, wire, full).reshape(-1).astype(jnp.uint32))
    bbox = jnp.stack([r_lo, r_hi, c_lo, c_hi]).astype(jnp.uint32)
    return jnp.concatenate([bbox] + pixels)


def _append_rider(flat, rider):
    """Concatenate the uint32 rider onto a band's flat transfer buffer,
    re-encoded to the buffer's dtype when the band is not u32-packed."""
    if flat.dtype == jnp.uint32:
        return jnp.concatenate([flat, rider])
    rb = lax.bitcast_convert_type(rider.reshape(-1, 1), flat.dtype).reshape(-1)
    return jnp.concatenate([flat, rb])


def colorize_convert_fetch(
    config: Config,
    state: RenderState,
    *,
    transparent: bool,
    eight_bit: bool,
    bands: Optional[int] = None,
    crop: Optional[bool] = None,
) -> np.ndarray:
    """Tone-map + deliverable-convert in row bands, overlapping the host
    fetch of each band with the device compute of the next.

    The plain pipeline serializes colorize before the multi-MB host fetch;
    banding hides all but the first band's compute behind the transfers.
    The global reductions colorize needs (max count /
    depth z-range) run once over the FULL canvas, so every band's
    elementwise math — and therefore the assembled frame — is bit-identical
    to the unbanded ``colorize`` + ``convert_format`` result (pinned in
    tests/test_export.py).

    ``bands``: explicit arg > ``SAR_COLORIZE_BANDS`` env > 8, snapped to the
    largest divisor of the canvas height at most the request. ``bands=1``
    (or a 1-row canvas) is exactly the plain pipeline.

    ``crop`` (default on; ``SAR_CROP_FETCH=0`` disables): lit-bbox cropped
    delivery. Unlit pixels tone-map to one constant, so only the lit
    bounding box needs to be copied to the host. The bbox is learned with
    zero extra round trips: every banded fetch appends a tiny rider (actual
    bbox excluding the reference's flood pixel (0,0) + unlit fill value +
    pixel (0,0)'s own value; 4+2*channels uint32s) to band 0's transfer,
    cached per deliverable; the NEXT delivery crops to the cached bbox
    (snapped to 8-row/64-col quanta with one quantum of margin) and its own
    rider re-verifies containment and fill equality, falling back to the
    full-canvas fetch on any mismatch (support growth in progressive
    renders, config reuse across states). First delivery in a process is
    therefore always full-canvas; repeated deliveries — bench attempts,
    preview loops, progressive refinement — ride the crop.

    The band count, the crop and the u32 packing were tuned for a slow
    device-to-host link on the system's first accelerator; what each is
    worth on the H100 is not yet measured (ROADMAP 3.2).
    Output is bit-identical either way (pinned in tests/test_crop_fetch.py).
    """
    import os

    from .ops.colorize import colorize_stats
    from .utils.export import convert_format_device, fetch_image

    h, w = state.shape
    if bands is None:
        bands = int(os.environ.get("SAR_COLORIZE_BANDS", "8"))
    if crop is None:
        crop = os.environ.get("SAR_CROP_FETCH", "1") != "0"
    bands = max(1, int(bands))
    bands_full = _largest_divisor_at_most(h, bands)
    wire, full = _wire_channels(config, transparent)
    if bands_full <= 1 and (not crop or bands <= 1):
        img = convert_format_device(colorize(config, state), transparent, eight_bit)
        img = _slice_wire(img, wire, full)
        return _expand_wire(fetch_image(img), wire, full)

    base_key = (
        config.colors.palette.fingerprint(),
        config.colors.brightness.offset,
        config.colors.brightness.factor,
        config.render.value,
        config.transparent,
        state.strategy.value,
        (h, w),
        bool(transparent),
        bool(eight_bit),
    )
    ckey = base_key + (bands,)
    fns = _BANDED_CACHE.get(ckey)
    if fns is None:

        @jax.jit
        def stats_fn(st):
            return colorize_stats(config, *state_planes(st))

        band_fns: dict = {}

        def get_band_fn(nrows: int, ncols: int, with_rider: bool):
            fn = band_fns.get((nrows, ncols, with_rider))
            if fn is None:

                @jax.jit
                def fn(st, r_start, c_start, stats):
                    def sl(p):
                        if p is None:
                            return None
                        q = lax.dynamic_slice_in_dim(p, r_start, nrows, axis=0)
                        if ncols != w:
                            q = lax.dynamic_slice_in_dim(q, c_start, ncols, axis=1)
                        return q

                    sliced = RenderState(*(sl(p) for p in st))
                    img = colorize_planes(config, *state_planes(sliced), stats=stats)
                    img = convert_format_device(img, transparent, eight_bit)
                    # DEPTH wire reduction (_wire_channels): copy only the
                    # gray channel to the host
                    img = _slice_wire(img, wire, full)
                    flat = img.reshape(-1)
                    per = 4 // flat.dtype.itemsize
                    if per > 1 and flat.shape[0] % per == 0:
                        # u32-packed transfer (utils/export.fetch_image)
                        flat = lax.bitcast_convert_type(
                            flat.reshape(-1, per), jnp.uint32)
                    if with_rider:
                        flat = _append_rider(
                            flat,
                            _rider_bits(config, st, stats, transparent, eight_bit))
                    return flat

                band_fns[(nrows, ncols, with_rider)] = fn
            return fn

        fns = (stats_fn, get_band_fn)
        _BANDED_CACHE[ckey] = fns
    stats_fn, get_band_fn = fns

    channels = wire  # everything below runs in wire channels; returns expand
    dtype = np.uint8 if eight_bit else np.uint16
    rider_len = 4 + 2 * channels

    def parse_rider(arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        if arr.dtype == np.uint32:
            rider, body = arr[-rider_len:], arr[:-rider_len]
        else:
            n = rider_len * (4 // arr.itemsize)
            rider, body = arr[-n:].view(np.uint32), arr[:-n]
        bbox = tuple(int(v) for v in rider[:4])
        fill = tuple(int(v) for v in rider[4:4 + channels])
        corner = tuple(int(v) for v in rider[4 + channels:])
        return body, bbox, fill, corner

    stats = stats_fn(state)
    cached = _CROP_CACHE.get(base_key) if crop else None

    def deliver(window, cached_fill=None):
        """One banded fetch. window=None: full canvas. Returns
        (assembled-or-None-if-rider-rejected, rider bbox, rider fill)."""
        if window is None:
            r0, r1, c0, c1 = 0, h, 0, w
            rows_per = h // bands_full
            spans = [(k * rows_per, rows_per) for k in range(bands_full)]
        else:
            r0, r1, c0, c1 = window
            rows_c = r1 - r0
            rows_per = -(-rows_c // bands)
            spans = []
            a = 0
            while a < rows_c:
                n = min(rows_per, rows_c - a)
                spans.append((r0 + a, n))
                a += n
        ncols = c1 - c0
        parts = [
            get_band_fn(n, ncols, with_rider=(idx == 0 and crop))(
                state, np.int32(start), np.int32(c0), stats)
            for idx, (start, n) in enumerate(spans)
        ]
        for p in parts:
            p.copy_to_host_async()
        hosts = [np.ascontiguousarray(np.asarray(jax.device_get(p)))
                 for p in parts]
        bbox = fill = corner = None
        if crop:
            hosts[0], bbox, fill, corner = parse_rider(hosts[0])
        if window is not None:
            a_lo, a_hi, b_lo, b_hi = bbox
            if not (r0 <= a_lo and a_hi <= r1 and c0 <= b_lo and b_hi <= c1
                    and fill == cached_fill):
                return None, bbox, fill
        out = np.empty((h, w, channels), dtype)
        if window is not None:
            fill_px = np.array(cached_fill, dtype)
            out[:r0] = fill_px
            out[r1:] = fill_px
            out[r0:r1, :c0] = fill_px
            out[r0:r1, c1:] = fill_px
        for (start, n), hp in zip(spans, hosts):
            out[start:start + n, c0:c1] = hp.view(dtype).reshape(
                n, ncols, channels)
        if window is not None:
            # the bbox excludes pixel (0,0) (the reference's flood-pixel
            # quirk pins escaping presets' bbox to the origin); its exact
            # converted value rides with THIS delivery — a no-op when the
            # corner is unlit (its output is the fill) or inside the window
            out[0, 0] = np.array(corner, dtype)
        return out, bbox, fill

    if cached is not None:
        window = _crop_window(cached["bbox"], h, w)
        if window is not None:
            out, bbox, fill = deliver(window, cached_fill=cached["fill"])
            _CROP_CACHE[base_key] = {"bbox": bbox, "fill": fill}
            if out is not None:
                return _expand_wire(out, wire, full)

    out, bbox, fill = deliver(None)
    if crop:
        _CROP_CACHE[base_key] = {"bbox": bbox, "fill": fill}
    return _expand_wire(out, wire, full)


def render_frame(config: Config, key=None, *, angle: Optional[float] = None) -> np.ndarray:
    """One-shot: fresh state -> render -> colorize -> host uint16 array.

    Delivery goes through :func:`colorize_convert_fetch` with the identity
    conversion (transparent u16), so the one-shot API gets the same banded,
    lit-bbox-cropped, wire-reduced (DEPTH) fetch the CLI ships through —
    bit-identical to a plain ``colorize`` + ``device_get``."""
    state = render(config, None, key, angle=angle)
    return colorize_convert_fetch(config, state, transparent=True, eight_bit=False)


def render_parallel(config: Config, key=None, *, devices=None, jobs_per_thread: int = 12) -> np.ndarray:
    """Render using every visible device (reference: src/lib.rs:1051-1082).

    With one device this equals :func:`render_frame`; with more, trajectory
    lanes shard across the mesh and the canvases merge with collectives
    (count: psum; depth/steps: max-by-key) — the device replacement for the
    thread pool + ``Runtime::merge`` fold.

    ``jobs_per_thread`` is accepted for signature parity with the reference
    (src/lib.rs:1051-1058) and ignored: SPMD lanes are statically balanced,
    so there is no work stealing to tune.
    """
    del jobs_per_thread
    devices = devices if devices is not None else jax.devices()
    if len(devices) <= 1:
        return render_frame(config, key)
    from .parallel.mesh import render_sharded

    state = render_sharded(config, devices, seed_key(config, key))
    # banded + cropped + wire-reduced delivery, identity conversion (the
    # banded path accepts sharded states — tests/test_parallel.py)
    return colorize_convert_fetch(config, state, transparent=True, eight_bit=False)


def _canvas_stepper(
    config: Config, strategy: BinStrategy, lanes: int, chunk_steps: int,
    *, vmapped: bool = False
):
    """The two halves of a single-canvas render, for callers that dispatch
    chunk groups themselves (the grouped mesh path, parallel.mesh):

    - ``init(key) -> (cur, prev, age, rkey)``: seed + warm-up, and the same
      reseed-key fold as :func:`_canvas_body` — so composing ``run`` over
      any group split is bit-identical to one full-length run.
    - ``run(nchunks, planes, cur, prev, age, rkey, cos, sin)``: advance
      ``nchunks`` chunks, returning the updated carries.
    """
    cam = camera_params(config.view, 0.0, config.width, config.height)
    dt = _dtype(config)
    step = _step_fn(config, cam, strategy)
    bin_planes = _bin_fn(config, strategy, vmapped=vmapped)

    def init(key):
        cur = _seed_warm(config, lanes, dt, key)
        age = jnp.zeros((lanes,), jnp.int32)
        rkey = jax.random.fold_in(key, 0x5EED)
        return cur, cur, age, rkey

    def run(nchunks, planes, cur, prev, age, rkey, cos_v, sin_v):
        def chunk(carry, _):
            planes, cur, prev, age, rkey = carry
            return _chunk_update(
                config, step, bin_planes, chunk_steps, dt,
                planes, cur, prev, age, rkey, cos_v, sin_v,
            ), None

        (planes, cur, prev, age, rkey), _ = lax.scan(
            chunk, (planes, cur, prev, age, rkey), None, length=nchunks
        )
        return planes, cur, prev, age, rkey

    return init, run


def _canvas_body(
    config: Config, strategy: BinStrategy, lanes: int, chunk_steps: int, nchunks: int,
    *, vmapped: bool = False
):
    """One full single-canvas render as a pure function
    ``(key, cos, sin) -> accumulator planes`` — the unit that gets vmapped
    over frames and shard_mapped over devices. Callers that vmap it MUST
    pass ``vmapped=True`` (see :func:`_bin_fn`: a batched flood-gate cond
    executes both pipelines). ``chunk_steps`` must come from
    the same :func:`plan_schedule` as ``nchunks`` (it clamps for small
    iteration counts)."""
    init, run = _canvas_stepper(config, strategy, lanes, chunk_steps, vmapped=vmapped)
    npix = config.width * config.height

    def body(key, cos_v, sin_v):
        cur, prev, age, rkey = init(key)
        # one source of truth for blank planes (RenderState.blank): a
        # hand-rolled copy here would have to track layout/sentinel changes
        acc = _state_to_planes(RenderState.blank((npix,), strategy), strategy)
        acc, _, _, _, _ = run(nchunks, acc, cur, prev, age, rkey, cos_v, sin_v)
        return acc

    return body


def _auto_frames_per_batch(
    config: Config, strategy: BinStrategy, lanes: int, chunk_steps: int
) -> int:
    """Frames per device program targeting ~2 GB of live canvases AND
    ~6 GB of per-chunk working set. Both budgets were sized for the
    system's first accelerator (16 GB of device memory) and are not yet
    re-chosen for the H100's 80 GB (ROADMAP 1.4).

    Bytes/px of the accumulation planes follow the *plane kind* (EXACT_KERNEL
    carries EXACT's 12 B/px planes; keying on the raw strategy made
    fidelity-mode batches overshoot ~1.25x and risk OOM), plus 8 B/px for
    the colorized u16 RGBA frame. The working-set term exists because vmap
    advances every frame's chunk in lock-step: the emitted point buffers
    (and their sorted copies in the sort-bin pipeline) materialize for ALL
    frames at once — a small canvas with the default 4M-point chunks would
    otherwise batch thousands of frames and OOM on the chunk buffers, which
    the canvas-only estimate never saw.
    """
    kind = strategy.planes_kind()
    npix = config.width * config.height
    plane_bytes = {
        BinStrategy.EXACT: 12,
        BinStrategy.PACKED: 8,
        BinStrategy.DEPTH: 4,
    }[kind]
    emit_bytes = {
        BinStrategy.EXACT: 12,  # flat + z + val
        BinStrategy.PACKED: 8,  # flat + packed
        BinStrategy.DEPTH: 8,  # flat + z
    }[kind]
    canvas = npix * (plane_bytes + 8)
    # emitted buffer + sorted copy + apply slack ~ 3x
    work = lanes * chunk_steps * emit_bytes * 3
    return max(1, min(int(2e9 / max(1, canvas)), int(6e9 / max(1, work))))


def _auto_frames_canvas_only(config: Config, strategy: BinStrategy) -> int:
    """Frames per device program targeting ~2 GB of live canvases only —
    the shared-orbit batch cap: the frame SCAN reuses one frame's chunk/sort
    buffers, so :func:`_auto_frames_per_batch`'s lock-step working-set term
    does not apply (round-4 advisor finding for the mesh shared path)."""
    kind = strategy.planes_kind()
    npix = config.width * config.height
    plane_bytes = {
        BinStrategy.EXACT: 12,
        BinStrategy.PACKED: 8,
        BinStrategy.DEPTH: 4,
    }[kind]
    return max(1, int(2e9 / max(1, npix * (plane_bytes + 8))))


def render_sequence_batched(
    config: Config,
    angles_deg,
    key=None,
    frames_per_batch: Optional[int] = None,
    transparent: bool = True,
    eight_bit: bool = False,
) -> np.ndarray:
    """Render a batch of camera angles as one vmapped device program.

    The frame axis becomes a vmap axis over the whole render+colorize
    pipeline (BASELINE.json configs[4]): all frames' trajectories advance in
    lock-step and the per-frame canvases live on device simultaneously, so
    ``frames_per_batch`` bounds memory (default: ~2 GB of canvases).
    Returns (F, H, W, C) frames ordered like ``angles_deg``.

    ``transparent`` / ``eight_bit`` apply the reference CLI's deliverable
    conversion (main.rs:52-57) ON DEVICE before the host fetch — the 8-bit
    RGB deliverable is 2.7x fewer bytes than raw u16 RGBA. Defaults keep
    the original (F, H, W, 4) uint16 contract.
    """
    from .parallel.mesh import planes_to_state
    from .utils.export import convert_format_device, fetch_image

    strategy = config.resolved_bin_strategy()
    if config.iterations < 1:
        # match render()/render_sequence, which return blank canvases:
        # plan_schedule floors to one chunk, so the vmapped body would
        # otherwise bin lanes*chunk_steps real points per "empty" frame
        blank = RenderState.blank((config.height, config.width), strategy)
        frame = np.asarray(
            jax.device_get(
                convert_format_device(
                    colorize_planes(config, *state_planes(blank)),
                    transparent, eight_bit,
                )
            )
        )
        return np.broadcast_to(
            frame, (len(list(angles_deg)), *frame.shape)
        ).copy()
    lanes, chunk_steps, nchunks = plan_schedule(config)
    body = _canvas_body(config, strategy, lanes, chunk_steps, nchunks, vmapped=True)
    shape = (config.height, config.width)
    wire, full = _wire_channels(config, transparent)

    def one(k, cos_v, sin_v):
        st = planes_to_state(body(k, cos_v, sin_v), strategy, shape)
        img = colorize_planes(config, *state_planes(st))
        # flat (H*W*C,) frames on device; the host reshapes back
        img = convert_format_device(img, transparent, eight_bit)
        # DEPTH frames wire one gray channel (_wire_channels): 3x fewer
        # bytes to copy to the host
        return _slice_wire(img, wire, full).reshape(-1)

    # cache the compiled batch program like _KERNEL_CACHE/_SHARDED_CACHE:
    # per-call re-jit would re-trace for every invocation with the same
    # config
    ckey = (
        config.replace(angle=0.0, iterations=1, lanes=lanes,
                       chunk_steps=chunk_steps).fingerprint(),
        strategy.value, nchunks, bool(transparent), bool(eight_bit),
    )
    fn = _BATCHED_CACHE.get(ckey)
    if fn is None:
        fn = jax.jit(jax.vmap(one))
        _BATCHED_CACHE[ckey] = fn

    if frames_per_batch is None or frames_per_batch <= 0:
        # <= 0 means auto, matching render_sequence_sharded's contract
        # (0 used to crash with an opaque range() error — advisor finding)
        frames_per_batch = _auto_frames_per_batch(config, strategy, lanes, chunk_steps)

    angles = np.asarray(list(angles_deg), np.float64)
    if angles.size == 0:
        return np.zeros(
            (0, *shape, 4 if transparent else 3),
            np.uint8 if eight_bit else np.uint16,
        )
    rad = np.radians(angles)
    dt = _dtype(config)
    base = seed_key(config, key)
    out = []
    pending = None
    for lo in range(0, len(angles), frames_per_batch):
        hi = min(lo + frames_per_batch, len(angles))
        keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(lo, hi))
        imgs = fn(keys, jnp.asarray(np.cos(rad[lo:hi]), dt), jnp.asarray(np.sin(rad[lo:hi]), dt))
        # dispatches are async: batch N+1 is enqueued before batch N's
        # frames are pulled to host, so the device renders through each
        # fetch instead of idling (u32-bitcast fetch, utils/export). Holds
        # at most two batches of converted frames on device (~6 MB/frame
        # for the 8-bit case).
        if pending is not None:
            out.append(fetch_image(pending))
        pending = imgs
    out.append(fetch_image(pending))
    frames = np.concatenate(out, axis=0).reshape(len(angles), *shape, -1)
    return _expand_wire(frames, wire, full)


def _canvas_body_shared(
    config: Config, strategy: BinStrategy, lanes: int, chunk_steps: int, nchunks: int,
    *, frame_vmap: bool = False,
):
    """Shared-orbit sequence render as a pure function
    ``(key, cos_vec, sin_vec) -> stacked accumulator planes (F, ...)``.

    One orbit (seed + 1000-step warm-up + map scan) serves every frame: each
    chunk's frame-invariant emission (:func:`_step_fn_shared`) is finished
    per frame by :func:`_project_emit` and binned per frame.

    ``frame_vmap=False`` (default) SCANS the frame axis: per-frame binning
    runs serially, reusing ONE frame's buffers. ``frame_vmap=True``
    batches all frames' binning into one wide program but materializes
    every frame's emission and sort buffers at once (~5 GB at 60 frames).
    The scan was the faster of the two on the system's first accelerator;
    on the H100 neither is measured yet (ROADMAP 3.5). Both orderings bin
    identical emissions per frame, so the resulting planes are
    bit-identical (tests/test_sequence_shared.py).
    """
    cam = camera_params(config.view, 0.0, config.width, config.height)
    dt = _dtype(config)
    step = _step_fn_shared(config, cam, strategy)
    npix = config.width * config.height
    # a vmapped flood-gate cond would execute BOTH binning pipelines
    # (select_n lowering) — always-evict instead, bit-exact (see _bin_fn)
    bin_planes = _bin_fn(config, strategy, vmapped=frame_vmap)

    def body(key, cos_vec, sin_vec):
        cur = _seed_warm(config, lanes, dt, key)
        prev = cur
        age = jnp.zeros((lanes,), jnp.int32)
        rkey = jax.random.fold_in(key, 0x5EED)
        blank = _state_to_planes(RenderState.blank((npix,), strategy), strategy)
        nframes = cos_vec.shape[0]
        planes = tuple(jnp.broadcast_to(p, (nframes, *p.shape)) for p in blank)

        def chunk(carry, _):
            planes, cur, prev, age, rkey = carry
            if config.reseed_lanes:
                rkey, cur, prev, age = _reseed_dead_lanes(config, rkey, cur, prev, age, dt)
            (x, y, z, px, py, pz, age), em = lax.scan(
                step, (*_split_xyz(cur), *_split_xyz(prev), age),
                None, length=chunk_steps, unroll=8,
            )
            cur, prev = _join_xyz(x, y, z), _join_xyz(px, py, pz)
            em = tuple(e.reshape(-1) for e in em)

            def frame_one(pl, cos_v, sin_v):
                return bin_planes(
                    pl, _project_emit(config, cam, strategy, cos_v, sin_v, em)
                )

            if frame_vmap:
                planes = jax.vmap(frame_one)(planes, cos_vec, sin_vec)
            else:
                _, planes = lax.scan(
                    lambda _, xs: (None, frame_one(*xs)),
                    None, (planes, cos_vec, sin_vec),
                )
            return (planes, cur, prev, age, rkey), None

        (planes, _, _, _, _), _ = lax.scan(
            chunk, (planes, cur, prev, age, rkey), None, length=nchunks
        )
        return planes

    return body


def render_sequence_shared(
    config: Config,
    angles_deg,
    key=None,
    frames_per_batch: Optional[int] = None,
    transparent: bool = True,
    eight_bit: bool = False,
) -> np.ndarray:
    """Render a camera-rotation sequence from ONE shared trajectory orbit.

    Same contract as :func:`render_sequence_batched` — returns (F, H, W, C)
    frames ordered like ``angles_deg`` — but all frames in a batch bin the
    SAME orbit sample set instead of each drawing its own. Per batch, every
    frame is bit-identical to a single :func:`render` of that batch's orbit
    key at that frame's angle (pinned in tests/test_sequence_shared.py), so
    per-frame fidelity is exactly a normal render's; across frames the
    sampling noise is coherent (points slide with the camera) instead of
    re-drawn, which reads as temporally smoother animation. The reference
    draws fresh OS entropy per frame (src/bin/main.rs:496-512, lib.rs:656)
    — for that statistically independent behavior use
    :func:`render_sequence_batched` (CLI ``--orbit per-frame``).

    Only the horizontal-projection multiplies depend on the camera angle,
    so the seed + 1000-iteration warm-up (src/lib.rs:748-752) and the whole
    map loop run ONCE per batch instead of once per frame, and only ONE
    frame's sort buffers are live at a time (the frame axis is a scan).
    Its speed against the per-frame batched path is not yet measured on
    the H100 (ROADMAP 3.5).

    ``frames_per_batch`` bounds device memory (default ~2 GB of canvases;
    the frame scan reuses one frame's chunk/sort buffers, so no working-set
    term applies); each batch renders its own orbit
    (``fold_in(base, batch_start)``).
    """
    strategy = config.resolved_bin_strategy()
    angles = np.asarray(list(angles_deg), np.float64)
    if config.iterations < 1 or angles.size == 0:
        # blank frames carry no orbit: identical to the batched path's result
        return render_sequence_batched(
            config, angles, key, frames_per_batch,
            transparent=transparent, eight_bit=eight_bit,
        )
    from .parallel.mesh import planes_to_state
    from .utils.export import convert_format_device, fetch_image

    lanes, chunk_steps, nchunks = plan_schedule(config)
    body = _canvas_body_shared(config, strategy, lanes, chunk_steps, nchunks)
    shape = (config.height, config.width)
    wire, full = _wire_channels(config, transparent)

    def seq(k, cos_vec, sin_vec):
        planes = body(k, cos_vec, sin_vec)

        def col(*pl):
            st = planes_to_state(pl, strategy, shape)
            img = colorize_planes(config, *state_planes(st))
            # flat (H*W*C,) on device: a (F, H, W, 4) u16 batch pads the
            # 4-wide minor dim to 128 lanes (32x HBM) — host reshapes back
            img = convert_format_device(img, transparent, eight_bit)
            # DEPTH wire reduction (_wire_channels): 3x fewer bytes
            return _slice_wire(img, wire, full).reshape(-1)

        return jax.vmap(col)(*planes)

    ckey = (
        config.replace(angle=0.0, iterations=1, lanes=lanes,
                       chunk_steps=chunk_steps).fingerprint(),
        strategy.value, nchunks, bool(transparent), bool(eight_bit),
    )
    fn = _SHARED_SEQ_CACHE.get(ckey)
    if fn is None:
        fn = jax.jit(seq)
        _SHARED_SEQ_CACHE[ckey] = fn

    if frames_per_batch is None or frames_per_batch <= 0:
        # <= 0 means auto (mesh-path contract); canvas-bound only — the
        # frame scan reuses ONE frame's chunk/sort buffers, so
        # _auto_frames_per_batch's 6 GB working-set term does not apply
        frames_per_batch = _auto_frames_canvas_only(config, strategy)

    rad = np.radians(angles)
    dt = _dtype(config)
    base = seed_key(config, key)
    out = []
    pending = None
    for lo in range(0, len(angles), frames_per_batch):
        hi = min(lo + frames_per_batch, len(angles))
        bkey = jax.random.fold_in(base, lo)
        imgs = fn(bkey, jnp.asarray(np.cos(rad[lo:hi]), dt),
                  jnp.asarray(np.sin(rad[lo:hi]), dt))
        # overlap: enqueue batch N+1 before fetching batch N (see
        # render_sequence_batched)
        if pending is not None:
            out.append(fetch_image(pending))
        pending = imgs
    out.append(fetch_image(pending))
    frames = np.concatenate(out, axis=0).reshape(len(angles), *shape, -1)
    return _expand_wire(frames, wire, full)


def render_sequence(
    config: Config,
    start_deg: float,
    end_deg: float,
    step_deg: float,
    key=None,
) -> Iterator[tuple[float, np.ndarray]]:
    """Animation frames rotating the camera (reference ``sequence``
    subcommand, src/bin/main.rs:327-367 + AngleIter, main.rs:107-176).

    Yields ``(angle_degrees, image)``. Frames reuse the compiled kernels —
    only the traced cos/sin change per frame (the reference re-renders per
    frame on the same thread pool, main.rs:496-512).

    Each frame folds its index into one base key (the reference draws fresh
    OS entropy per frame, main.rs:656,748) — without the fold a SEEDED
    config would replay the identical trajectory sample set every frame.
    The fold matches :func:`render_sequence_batched`, so a seeded sequence
    is frame-identical across the per-frame and batched paths.
    """
    from .utils.sequencing import angle_iter

    base = seed_key(config, key)
    for i, angle_deg in enumerate(angle_iter(start_deg, end_deg, step_deg)):
        image = render_frame(
            config, jax.random.fold_in(base, i), angle=float(np.radians(angle_deg))
        )
        yield angle_deg, image
