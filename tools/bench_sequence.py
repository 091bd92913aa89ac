"""Sequence throughput: the 120-frame 360-degree rotation workload
(BASELINE.json configs[4]; reference `sequence` subcommand,
reference src/bin/main.rs:136-157) batched on device.

Prints ONE JSON line with device-side throughput (render + colorize of all
frames, synced with ``block_until_ready``), the per-frame host-fetch cost,
and the delivered-sequence walls of both sequence engines. Frames are the
reference CLI-default budget (1e7 iterations, src/bin/main.rs:215) at
1920x1080.

The timed loop is the same vmapped render+colorize program
``render_sequence_batched`` runs, driven directly so each batch syncs on
the device instead of with a full-frame transfer.

Usage: python tools/bench_sequence.py  [SEQ_FRAMES=120] [SEQ_ITERS=1e7]
(defaults on a GPU; a token 4 x 2e5 elsewhere)
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from strange_attractor_tpu import presets
    from strange_attractor_tpu.ops.colorize import colorize_planes, state_planes
    from strange_attractor_tpu.parallel.mesh import planes_to_state
    from strange_attractor_tpu.render import (
        _auto_frames_per_batch, _canvas_body, _canvas_body_shared, _dtype,
        plan_schedule, seed_key,
    )
    from strange_attractor_tpu.utils.export import fetch_image
    from strange_attractor_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    on_gpu = dev.platform == "gpu"
    frames = int(float(os.environ.get("SEQ_FRAMES", "120" if on_gpu else "4")))
    iters = int(float(os.environ.get("SEQ_ITERS", "1e7" if on_gpu else "2e5")))
    cfg = presets.poisson_saturne(iterations=iters, width=1920, height=1080,
                                  seed=0, silent=True)
    strategy = cfg.resolved_bin_strategy()
    lanes, chunk, nchunks = plan_schedule(cfg)
    per_frame = lanes * chunk * nchunks

    # the same per-frame program render_sequence_batched vmaps: vmapped=True
    # compiles the static always-evict flood path — without it the batched
    # cond lowers to select_n and runs BOTH binning pipelines (~2x), so the
    # tool would measure a program production never executes
    body = _canvas_body(cfg, strategy, lanes, chunk, nchunks, vmapped=True)
    shape = (cfg.height, cfg.width)

    def one(k, cos_v, sin_v):
        st = planes_to_state(body(k, cos_v, sin_v), strategy, shape)
        # flat frames, like render_sequence_batched
        return colorize_planes(cfg, *state_planes(st)).reshape(-1)

    fn = jax.jit(jax.vmap(one))
    fpb = int(os.environ.get("SEQ_FPB", "0")) or _auto_frames_per_batch(
        cfg, strategy, lanes, chunk)
    dt = _dtype(cfg)
    base = seed_key(cfg)
    angles = np.linspace(0.0, 360.0, frames, endpoint=False)
    rad = np.radians(angles)

    def run(lo_hi_pairs):
        last = None
        for lo, hi in lo_hi_pairs:
            keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.arange(lo, hi))
            last = fn(keys, jnp.asarray(np.cos(rad[lo:hi]), dt),
                      jnp.asarray(np.sin(rad[lo:hi]), dt))
            # sync on the device without the 16.6 MB/frame transfer
            jax.block_until_ready(last)
        return last

    batches = [(lo, min(lo + fpb, frames)) for lo in range(0, frames, fpb)]
    run(batches[:1])  # warm both the full-batch and (if any) tail programs
    if batches[-1][1] - batches[-1][0] != fpb:
        run(batches[-1:])

    t0 = time.perf_counter()
    last = run(batches)
    device_s = time.perf_counter() - t0

    # shared-orbit variant (render_sequence_shared's device program): one
    # warm-up + map per batch, per-frame binning from the shared chunk
    # emission — same u16 RGBA colorize output for apples-to-apples timing
    body_shared = _canvas_body_shared(cfg, strategy, lanes, chunk, nchunks)

    def seq_dev(k, cos_vec, sin_vec):
        planes = body_shared(k, cos_vec, sin_vec)

        def col(*pl):
            st = planes_to_state(pl, strategy, shape)
            return colorize_planes(cfg, *state_planes(st)).reshape(-1)

        return jax.vmap(col)(*planes)

    fn_shared = jax.jit(seq_dev)

    def run_shared(lo_hi_pairs):
        last = None
        for lo, hi in lo_hi_pairs:
            last = fn_shared(jax.random.fold_in(base, lo),
                             jnp.asarray(np.cos(rad[lo:hi]), dt),
                             jnp.asarray(np.sin(rad[lo:hi]), dt))
            jax.block_until_ready(last)
        return last

    run_shared(batches[:1])
    if batches[-1][1] - batches[-1][0] != fpb:
        run_shared(batches[-1:])
    t0 = time.perf_counter()
    last_shared = run_shared(batches)
    shared_s = time.perf_counter() - t0
    assert float(last_shared.ravel().max()) > 0

    # one-frame fetch cost, measured separately (u16 RGBA deliverable)
    t0 = time.perf_counter()
    host = fetch_image(last[-1]).reshape(1080, 1920, 4)
    fetch_s = time.perf_counter() - t0
    assert host.max() > 0

    # true end-to-end for the delivered sequence: render + device-side
    # 8-bit RGB conversion + host fetch of EVERY frame (the CLI sequence
    # path with -8), reported separately from the device metric above so
    # both the renderer and the delivery pipeline have honest numbers.
    from strange_attractor_tpu.render import render_sequence_batched

    # warm the batched program OUTSIDE the timed region: its vmapped body +
    # convert + bitcast shapes differ from the tool's own jit above — one
    # tail-sized and one full-batch warm render cover both program shapes
    warm_n = min(frames, fpb)
    render_sequence_batched(
        cfg, angles[:warm_n], frames_per_batch=fpb, transparent=False, eight_bit=True
    )
    if frames % fpb:
        render_sequence_batched(
            cfg, angles[: frames % fpb], frames_per_batch=fpb,
            transparent=False, eight_bit=True,
        )

    t0 = time.perf_counter()
    imgs8 = render_sequence_batched(
        cfg, angles, frames_per_batch=fpb, transparent=False, eight_bit=True
    )
    e2e_s = time.perf_counter() - t0
    assert imgs8.shape == (frames, 1080, 1920, 3) and imgs8.dtype == np.uint8
    assert imgs8[-1].max() > 0

    # the same delivered-sequence wall through the shared-orbit path (CLI
    # `sequence --orbit shared -8`): one warm-up + map
    # per batch, per-frame binning, device-side 8-bit conversion, fetches
    # overlapped with the next batch's render
    from strange_attractor_tpu.render import render_sequence_shared

    sfpb = min(fpb, frames)
    render_sequence_shared(
        cfg, angles[:sfpb], frames_per_batch=sfpb, transparent=False,
        eight_bit=True,
    )
    if frames % sfpb:
        render_sequence_shared(
            cfg, angles[: frames % sfpb], frames_per_batch=sfpb,
            transparent=False, eight_bit=True,
        )
    t0 = time.perf_counter()
    imgs8s = render_sequence_shared(
        cfg, angles, frames_per_batch=sfpb, transparent=False, eight_bit=True
    )
    e2e_shared_s = time.perf_counter() - t0
    assert imgs8s.shape == (frames, 1080, 1920, 3) and imgs8s.dtype == np.uint8
    assert imgs8s[-1].max() > 0

    total_iters = frames * per_frame
    print(json.dumps({
        "metric": "sequence frames/sec (device render+colorize)",
        "value": round(frames / device_s, 3),
        "unit": "frames/s",
        "frames": frames,
        "iters_per_frame": per_frame,
        "frames_per_batch": fpb,
        "device_s": round(device_s, 3),
        "iters_per_sec": round(total_iters / device_s, 1),
        "shared_orbit_device_s": round(shared_s, 3),
        "shared_orbit_frames_per_sec": round(frames / shared_s, 3),
        "shared_orbit_iters_per_sec": round(total_iters / shared_s, 1),
        "fetch_s_per_frame_u16rgba": round(fetch_s, 3),
        "e2e_8bit_s": round(e2e_s, 3),
        "e2e_frames_per_sec": round(frames / e2e_s, 3),
        "e2e_fetched_mb": round(imgs8.nbytes / 1e6, 1),
        "e2e_shared_8bit_s": round(e2e_shared_s, 3),
        "e2e_shared_frames_per_sec": round(frames / e2e_shared_s, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
