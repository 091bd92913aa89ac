"""Multi-device rendering over a ``jax.sharding.Mesh``.

The reference scales with a thread pool + channels + a work-stealing atomic
counter (src/lib.rs:906-1031) and merges per-thread canvases on the main
thread (src/lib.rs:1068-1076). The device equivalents:

- **lanes axis (data parallel)**: trajectory lanes shard across devices via
  ``shard_map``; every device accumulates a private canvas — the analog of a
  per-thread ``Runtime`` — entirely on device.
- **merge = collectives between devices**: ``psum`` for the visit counts and a
  max-by-key reduction for the depth/color planes, replacing the reference's
  O(W*H*threads) sequential merge loop. PACKED states need a single
  ``pmax``; EXACT states resolve the winning device per pixel with
  pmax + pmin(tie-break by device index) + psum.
- **frames axis**: animation frames are embarrassingly parallel
  (src/bin/main.rs:496-512 renders them serially); a second mesh axis shards
  the angle batch.

Work stealing is unnecessary: lanes are statically balanced because every
lane runs the identical instruction stream (SPMD), unlike CPU threads with
variable scheduling.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import BinStrategy, Config
from ..runtime import RenderState


def _split_lanes(config: Config, lanes_total: int, ndev: int) -> int:
    """Per-device lane count. A hand-pinned ``Config.lanes`` that does not
    divide the device count silently loses budget (100 lanes on 8 devices
    executes 96); warn so the truncation is visible. Auto-resolved lane
    counts are multiples of 256 and never trip this on power-of-two
    meshes."""
    lanes_local = max(1, lanes_total // ndev)
    if config.lanes is not None and lanes_local * ndev != lanes_total:
        import warnings

        warnings.warn(
            f"lanes={lanes_total} does not divide the {ndev}-device mesh; "
            f"executing {lanes_local * ndev} lanes ({lanes_local}/device). "
            "Pin a multiple of the device count for the exact budget.",
            stacklevel=3,
        )
    return lanes_local


def lanes_mesh(devices=None) -> Mesh:
    """1D mesh over all (or the given) devices: axis ``lanes``."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), ("lanes",))


def merge_collective(planes: tuple, strategy: BinStrategy, axis: str) -> tuple:
    """Merge per-device canvases along ``axis`` (semantics of
    ``Runtime::merge``, src/lib.rs:708-738, as collectives)."""
    strategy = strategy.planes_kind()  # KERNEL merges like PACKED
    if strategy == BinStrategy.DEPTH:
        return (lax.pmax(planes[0], axis),)
    if strategy == BinStrategy.PACKED:
        count, packed = planes
        return lax.psum(count, axis), lax.pmax(packed, axis)
    count, steps, zbuf = planes
    count = lax.psum(count, axis)
    zmax = lax.pmax(zbuf, axis)
    nproc = lax.axis_size(axis)
    me = lax.axis_index(axis)
    winner = (zbuf == zmax) & (zbuf > -1.0)
    # deterministic tie-break: lowest device index wins (the reference's fold
    # order makes the first thread win ties, src/lib.rs:726-735)
    widx = lax.pmin(jnp.where(winner, me, nproc), axis)
    steps = lax.psum(jnp.where(winner & (me == widx), steps, 0.0), axis)
    return count, steps, zmax


def _local_render_fn(
    config: Config, strategy: BinStrategy, lanes: int, chunk_steps: int, nchunks: int,
    axis: str, *, vmapped: bool = False
):
    """Build the per-device render body (runs inside ``shard_map``): a plain
    single-canvas render with a device-unique key, merged collectively.
    ``vmapped=True`` when the body is additionally vmapped over frames
    (render_sequence_sharded) — see render._bin_fn's flood-gate note."""
    from ..render import _canvas_body

    canvas = _canvas_body(config, strategy, lanes, chunk_steps, nchunks, vmapped=vmapped)

    def body(key, cos_v, sin_v):
        key = jax.random.fold_in(key, lax.axis_index(axis))
        return merge_collective(canvas(key, cos_v, sin_v), strategy, axis)

    return body


_SHARDED_CACHE: dict = {}


def _sharded_cache_key(config, strategy, lanes, chunk_steps, nchunks, devices, kind):
    pinned = config.replace(angle=0.0, iterations=1, lanes=lanes, chunk_steps=chunk_steps)
    return (
        pinned.fingerprint(),
        strategy.value,
        nchunks,
        kind,
        tuple(str(d) for d in devices),
    )


def render_sharded(config: Config, devices=None, key=None, *,
                   state: RenderState | None = None,
                   on_progress=None) -> RenderState:
    """Render with trajectory lanes sharded over every device; returns the
    merged (replicated) state. Device analog of ``render_parallel``
    (src/lib.rs:1051-1082). Compiled programs are cached (angle is a traced
    argument), so per-frame calls don't recompile.

    ``state`` resumes a standing accumulation on the mesh (the multi-device
    form of :func:`render.render`'s progressive refinement): the new
    iterations render sharded and fold into the standing planes with
    ``runtime.merge`` — bit-identical to continuing the accumulation
    through the chunk loop, because every plane update is the same
    commutative/associative op the merge applies (count +, packed max,
    strict-> z-test with standing-wins ties; pinned in
    tests/test_parallel.py). Seeded configs derive the same content-based
    continuation key as the single-device path (render.progressive_key).

    ``on_progress(done_chunks, total_chunks, partial_state)`` splits the
    mesh render into :data:`render.DISPATCH_GROUP`-chunk dispatches — the
    multi-device form of :func:`render.render`'s hook: per-device carries
    (planes, trajectories) persist across dispatches, so the grouped run is
    bit-identical to the single-program one, and each boundary collectively
    merges the private canvases into the replicated partial state the
    callback sees. Grouped dispatch costs one canvas merge per group.
    """
    from ..render import plan_schedule, progressive_key, seed_key
    from ..runtime import merge

    mesh = lanes_mesh(devices)
    ndev = mesh.devices.size
    resolved = config.resolved_bin_strategy()
    if state is None:
        strategy = resolved
    else:
        if state.shape != (config.height, config.width):
            raise ValueError(
                f"state canvas {state.shape} does not match config "
                f"{(config.height, config.width)}; use state.set_width_height() "
                "for a reset state of the new size"
            )
        # plane-compatible resume, like render(): a PACKED-plane checkpoint
        # continues through the KERNEL path (same layout and semantics)
        strategy = resolved if resolved.planes_kind() == state.strategy else state.strategy
        if key is None and config.seed is not None:
            key = progressive_key(config, state)
    if config.iterations < 1 and state is not None:
        return state
    lanes_total, chunk_steps, nchunks = plan_schedule(config)
    lanes_local = _split_lanes(config, lanes_total, ndev)

    key = seed_key(config, key)
    dt = jnp.dtype(config.dtype)
    cos_v = jnp.asarray(np.cos(config.angle), dt)
    sin_v = jnp.asarray(np.sin(config.angle), dt)

    if on_progress is None:
        ckey = _sharded_cache_key(
            config, strategy, lanes_local, chunk_steps, nchunks, mesh.devices.flat, "lanes"
        )
        fn = _SHARDED_CACHE.get(ckey)
        if fn is None:
            body = _local_render_fn(config, strategy, lanes_local, chunk_steps, nchunks, "lanes")
            fn = jax.jit(
                shard_map(
                    body,
                    mesh=mesh,
                    in_specs=(P(), P(), P()),
                    out_specs=P(),
                    check_vma=False,
                )
            )
            _SHARDED_CACHE[ckey] = fn
        planes = fn(key, cos_v, sin_v)
        fresh = planes_to_state(planes, strategy, (config.height, config.width))
    else:
        fresh = _render_sharded_grouped(
            config, strategy, mesh, lanes_local, chunk_steps, nchunks,
            key, cos_v, sin_v, on_progress, state,
        )
    return fresh if state is None else merge(state, fresh)


def _render_sharded_grouped(
    config: Config, strategy: BinStrategy, mesh: Mesh,
    lanes_local: int, chunk_steps: int, nchunks: int,
    key, cos_v, sin_v, on_progress, standing: RenderState | None,
) -> RenderState:
    """Multi-dispatch mesh render: per-device carries persist across
    DISPATCH_GROUP-chunk programs; each group boundary runs the collective
    canvas merge and hands the replicated partial state to ``on_progress``
    (merged with the standing state for resumed renders, so previews show
    the actual progressive image).

    Bit-identity with the single-program path: the init program performs
    the same per-device key fold and warm-up as ``_local_render_fn``'s
    body, and composing the chunk scan over groups executes the identical
    chunk sequence (tests/test_parallel.py pins the equality).
    """
    from ..render import DISPATCH_GROUP, _canvas_stepper, _state_to_planes
    from ..runtime import merge

    devices = mesh.devices.flat
    init_local, run_local = _canvas_stepper(config, strategy, lanes_local, chunk_steps)
    npix = config.width * config.height
    shape = (config.height, config.width)

    def cache(kind, build):
        ck = _sharded_cache_key(
            config, strategy, lanes_local, chunk_steps, nchunks, devices, kind
        )
        fn = _SHARDED_CACHE.get(ck)
        if fn is None:
            fn = build()
            _SHARDED_CACHE[ck] = fn
        return fn

    # all per-device carries are sharded on their leading axis; shard_map
    # hands the body local blocks with that axis divided by the mesh size
    sharded = P("lanes")

    def build_init():
        def body(key):
            k = jax.random.fold_in(key, lax.axis_index("lanes"))
            cur, prev, age, rkey = init_local(k)
            blank = _state_to_planes(RenderState.blank((npix,), strategy), strategy)
            # leading device axis of size 1 per shard (concatenates to ndev)
            return tuple(jnp.stack([p]) for p in (*blank, cur, prev, age, rkey))

        return jax.jit(shard_map(
            body, mesh=mesh, in_specs=(P(),), out_specs=sharded, check_vma=False,
        ))

    def build_group(n):
        def body(carry, cos_v, sin_v):
            nplanes = len(carry) - 4
            planes = tuple(c[0] for c in carry[:nplanes])
            cur, prev, age, rkey = (c[0] for c in carry[nplanes:])
            out = run_local(n, planes, cur, prev, age, rkey, cos_v, sin_v)
            planes, cur, prev, age, rkey = out
            return tuple(jnp.stack([p]) for p in (*planes, cur, prev, age, rkey))

        def build():
            return jax.jit(shard_map(
                body, mesh=mesh,
                in_specs=(sharded, P(), P()), out_specs=sharded,
                check_vma=False,
            ))

        return cache(("lanes-group", n), build)

    def build_merge():
        def body(carry):
            nplanes = len(carry) - 4
            planes = tuple(c[0] for c in carry[:nplanes])
            return merge_collective(planes, strategy, "lanes")

        return jax.jit(shard_map(
            body, mesh=mesh, in_specs=(sharded,), out_specs=P(), check_vma=False,
        ))

    init_fn = cache(("lanes-init",), build_init)
    merge_fn = cache(("lanes-merge",), build_merge)

    carry = init_fn(key)
    inner = min(nchunks, DISPATCH_GROUP)
    outer_full, rem = divmod(nchunks, inner)
    done = 0

    def report():
        partial = planes_to_state(merge_fn(carry), strategy, shape)
        if standing is not None:
            partial = merge(standing, partial)
        on_progress(done, nchunks, partial)

    group_fn = build_group(inner)
    for _ in range(outer_full):
        carry = group_fn(carry, cos_v, sin_v)
        done += inner
        if done < nchunks:
            report()
    if rem:
        carry = build_group(rem)(carry, cos_v, sin_v)
        done += rem
    fresh = planes_to_state(merge_fn(carry), strategy, shape)
    # final callback sees the finished accumulation (matches render():
    # the last group also reports)
    partial = fresh if standing is None else merge(standing, fresh)
    on_progress(done, nchunks, partial)
    return fresh


def planes_to_state(planes, strategy: BinStrategy, shape) -> RenderState:
    """Reassemble a RenderState from flat accumulator planes."""
    strategy = strategy.planes_kind()
    if strategy == BinStrategy.PACKED:
        return RenderState(count=planes[0].reshape(shape), packed=planes[1].reshape(shape))
    if strategy == BinStrategy.DEPTH:
        return RenderState(zbuf=planes[0].reshape(shape))
    return RenderState(
        count=planes[0].reshape(shape),
        steps=planes[1].reshape(shape),
        zbuf=planes[2].reshape(shape),
    )


def render_sequence_sharded(
    config: Config,
    angles_deg: Sequence[float],
    devices=None,
    key=None,
    frame_axis: int = 0,
    transparent: bool = True,
    eight_bit: bool = False,
    frames_per_batch: int = 0,
    orbit: str = "per-frame",
):
    """Shard an animation over a 2D (frames, lanes) mesh.

    Each ``frames`` row of devices renders a contiguous slice of the angle
    batch while its lanes split across the ``lanes`` columns — the two forms
    of parallelism the workload actually has (SURVEY.md §2). Returns a host
    array of colorized frames, ordered like ``angles_deg``.

    The angle count is padded up to a multiple of the frames axis; padded
    frames are rendered (identical cost, SPMD) and dropped on the host.

    ``frames_per_batch`` bounds frames *per device* per compiled program
    (0 = the automatic ~2 GB memory cap). Without it a long sequence vmaps
    every frame's canvas
    plus lock-step chunk buffers into one program — the same working-set
    blow-up ``render_sequence_batched`` guards against with
    ``_auto_frames_per_batch``. The angle list is sliced into groups of
    ``frames_per_batch * frame_axis``; every group runs through ONE cached
    program (short tails are padded), and results concatenate on the host.

    ``orbit="shared"`` is the mesh form of
    :func:`render.render_sequence_shared`: each ``frames`` row renders its
    whole local frame slice from ONE trajectory orbit (warm-up + map once
    per row per group), with that orbit's lanes split across the ``lanes``
    columns and each frame's canvas merged collectively. Every frame is
    bit-identical to a :func:`render_sharded` of that row's orbit key over
    one row of devices at the frame's angle (pinned in
    tests/test_parallel.py), so the single-device shared-orbit guarantees
    — coherent sampling noise, per-frame fidelity of a normal render —
    transfer to the mesh. Rows draw distinct orbits (the frame-axis index
    folds into the key), so cross-row coherence is that of distinct seeds,
    like the single-device path's per-batch orbits.
    """
    from ..render import (
        _expand_wire, _slice_wire, _wire_channels, plan_schedule, seed_key,
    )
    from ..ops.colorize import colorize_planes, state_planes
    from ..utils.export import convert_format_device, fetch_image

    devices = list(devices) if devices is not None else jax.devices()
    ndev = len(devices)
    if len(angles_deg) == 0:
        return np.zeros(
            (0, config.height, config.width, 4 if transparent else 3),
            np.uint8 if eight_bit else np.uint16,
        )
    if config.iterations < 1:
        # match render()'s blank-canvas semantics (plan_schedule floors to
        # one real chunk; see render_sequence_batched)
        from ..render import render_sequence_batched

        return render_sequence_batched(
            config, angles_deg, key, transparent=transparent, eight_bit=eight_bit
        )
    if frame_axis <= 0:
        frame_axis = max(1, min(len(angles_deg), ndev))
    while ndev % frame_axis:
        frame_axis -= 1
    lane_axis = ndev // frame_axis
    mesh = Mesh(np.array(devices).reshape(frame_axis, lane_axis), ("frames", "lanes"))

    strategy = config.resolved_bin_strategy()
    lanes_total, chunk_steps, nchunks = plan_schedule(config)
    lanes_local = _split_lanes(config, lanes_total, lane_axis)

    nang = len(angles_deg)
    full_len = nang + ((-nang) % frame_axis)
    if frames_per_batch <= 0:
        if orbit == "shared":
            # the shared body SCANS its local frame slice, reusing one
            # frame's chunk/sort buffers — cap on canvases only, like
            # render_sequence_shared (the lock-step working-set term would
            # shrink groups ~3x for nothing: more dispatches, more orbit
            # seams per sequence)
            from ..render import _auto_frames_canvas_only

            frames_per_batch = _auto_frames_canvas_only(config, strategy)
        else:
            # the per-frame body vmaps frames in lock-step: same
            # canvas/working-set memory cap as the single-device batched
            # path (sized with this device's LOCAL lane share)
            from ..render import _auto_frames_per_batch

            frames_per_batch = _auto_frames_per_batch(
                config, strategy, lanes_local, chunk_steps
            )
    per_batch = frames_per_batch * frame_axis if frames_per_batch > 0 else 0
    if per_batch <= 0 or per_batch >= full_len:
        group_len = full_len
        groups = [np.asarray(angles_deg, np.float64)]
    else:
        group_len = per_batch
        groups = [
            np.asarray(angles_deg[i:i + per_batch], np.float64)
            for i in range(0, nang, per_batch)
        ]
    dt = jnp.dtype(config.dtype)

    if orbit not in ("per-frame", "shared"):
        raise ValueError(f"orbit must be 'per-frame' or 'shared', got {orbit!r}")
    ckey = _sharded_cache_key(
        config, strategy, lanes_local, chunk_steps, nchunks, devices,
        ("frames", frame_axis, group_len, transparent, eight_bit, orbit),
    )
    fn = _SHARDED_CACHE.get(ckey)

    wire, full = _wire_channels(config, transparent)

    def _colorize_flat(*pl):
        st = planes_to_state(pl, strategy, (config.height, config.width))
        img = colorize_planes(config, *state_planes(st))
        # deliverable conversion on device + flat per-frame output; the
        # host reshapes back
        img = convert_format_device(img, transparent, eight_bit)
        # DEPTH wire reduction (render._wire_channels): 3x fewer bytes
        return _slice_wire(img, wire, full).reshape(-1)

    if fn is None and orbit == "shared":
        from ..render import _canvas_body_shared

        canvas = _canvas_body_shared(config, strategy, lanes_local, chunk_steps,
                                     nchunks)

        def frames_body(key, cos_f, sin_f):
            # one orbit per frames-row, its lanes split over the lane
            # columns. Key derivation mirrors _local_render_fn's, so a row
            # is bit-identical to render_sharded(fold_in(key, row)) over one
            # row of devices at each of its frames' angles.
            key = jax.random.fold_in(key, lax.axis_index("frames"))
            key = jax.random.fold_in(key, lax.axis_index("lanes"))
            # stacked (F_local, npix) planes; the merge collectives are
            # elementwise/reductions over the mesh axis, so they apply to
            # the whole frame stack at once
            planes = canvas(key, cos_f, sin_f)
            planes = merge_collective(planes, strategy, "lanes")
            return jax.vmap(_colorize_flat)(*planes)

    elif fn is None:
        body = _local_render_fn(config, strategy, lanes_local, chunk_steps, nchunks,
                                "lanes", vmapped=True)

        def frames_body(key, cos_f, sin_f):
            key = jax.random.fold_in(key, lax.axis_index("frames"))

            def one(cs, local_frame):
                # fresh trajectories per frame (the reference draws fresh OS
                # entropy per frame, src/lib.rs:656,748) — without this every
                # frame in a device row would replay identical seeds
                planes = body(jax.random.fold_in(key, local_frame), cs[0], cs[1])
                return _colorize_flat(*planes)

            return jax.vmap(one)(
                jnp.stack([cos_f, sin_f], axis=1), jnp.arange(cos_f.shape[0])
            )

    if fn is None:
        fn = jax.jit(
            shard_map(
                frames_body,
                mesh=mesh,
                in_specs=(P(), P("frames"), P("frames")),
                out_specs=P("frames"),
                check_vma=False,
            )
        )
        _SHARDED_CACHE[ckey] = fn
    base_key = seed_key(config, key)
    outs = []
    for gi, g in enumerate(groups):
        rad = np.radians(np.concatenate([g, np.zeros(group_len - len(g))]))
        cos_all = jnp.asarray(np.cos(rad), dt)
        sin_all = jnp.asarray(np.sin(rad), dt)
        # distinct seeds per group (within a group the body folds the frame
        # index); single-group calls keep the historical key untouched
        gkey = jax.random.fold_in(base_key, gi) if len(groups) > 1 else base_key
        frames = fn(gkey, cos_all, sin_all)
        # u32-bitcast fast path; gathers the sharded result like device_get
        host = fetch_image(frames)
        outs.append(_expand_wire(
            host.reshape(host.shape[0], config.height, config.width, -1)[:len(g)],
            wire, full,
        ))
    return outs[0] if len(outs) == 1 else np.concatenate(outs)
