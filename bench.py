"""Benchmark: the reference workloads end to end on one GPU.

Workload 1 (the headline): poisson-saturne, 1e9 iterations, 1920x1080,
brightness -0.25 (reference README.md:72-73). Workload 2 (recorded in the
``solar_sail`` sub-object): solar-sail, 1e9 iterations, 1800x2000,
brightness -0.1 (reference README.md:74-75).

Prints ONE JSON line:
  {"metric": "map iterations/sec", "value": N, "unit": "iters/s",
   "device": {"platform": ..., "kind": ..., "count": ...},
   "wall_s": ..., "phases": {...}, "solar_sail": {...}, ...}

``value`` is the render phase's rate (fresh state -> planes, synced with
``block_until_ready``). ``wall_s`` is end to end: fresh state -> render ->
colorize -> device-side format conversion -> host fetch of the deliverable
8-bit RGB frame (the reference CLI's --8-bit export, src/bin/main.rs:52-57,
converted on device with identical rounding); ``wall_16bit_rgb_s`` is the
same with the reference's default 16-bit RGB deliverable. Host PNG encode
is not included. Every attempt is kept (``runs``, ``wall_runs``,
``phase_runs``).

Before any timed run every bin strategy is certified on the device against
the host oracle (strange_attractor_tpu/certify.py), so a wrong-but-fast
binning fails the bench instead of recording a number.

The bench measures a GPU: it exits non-zero when JAX finds none, unless the
CPU was requested with ``JAX_PLATFORMS=cpu`` (a rehearsal at a token
iteration count). ``BENCH_ITERS`` overrides the iteration count of both
workloads.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _measure(cfg, *, phase_attempts: int, wall_attempts: int, assert_shape) -> dict:
    """Render ``cfg`` end-to-end repeatedly; return the measurement record.

    Two instruments:
    - ``phase_runs``: a sync between render / colorize / fetch per attempt,
      giving the per-phase split and the iters/s metric (render phase only).
    - ``wall_runs``: the same pipeline with NO intermediate syncs —
      colorize and the format convert enqueue behind the render and the
      banded host fetch drains the queue — i.e. what a user waits for a
      frame. The banded delivery (`colorize_convert_fetch`) is the path
      cli.py ships frames through (bit-identical to plain, asserted during
      warm-up).
    """
    import jax
    import numpy as np

    from strange_attractor_tpu import colorize, render
    from strange_attractor_tpu.render import (
        colorize_convert_fetch,
        plan_schedule,
        precompile,
    )
    from strange_attractor_tpu.utils.export import convert_format_device, fetch_image
    from strange_attractor_tpu.utils.profiling import RenderProfile

    lanes, chunk_steps, nchunks = plan_schedule(cfg)
    executed = lanes * chunk_steps * nchunks

    @jax.jit
    def colorize8(st):
        # 8-bit RGB deliverable (reference --8-bit, no --transparent)
        return convert_format_device(colorize(cfg, st), False, True)

    # compile warm-up with precompile's returned state: its planes come from
    # the same remainder program as a real render's, so the consumers
    # compile for the same device layout the timed calls see
    state = precompile(cfg)
    warm8 = jax.block_until_ready(colorize8(state))
    np.testing.assert_array_equal(fetch_image(warm8), np.asarray(jax.device_get(warm8)))
    # warm the banded delivery twice (the second call compiles the cropped
    # band programs the timed attempts ride) and pin it to the plain path
    for _ in range(2):
        warm_banded = colorize_convert_fetch(cfg, state, transparent=False, eight_bit=True)
        np.testing.assert_array_equal(warm_banded, fetch_image(warm8))

    phase_runs = []
    for i in range(phase_attempts):
        prof = RenderProfile(iterations=executed)
        with prof.phase("render"):
            state = jax.block_until_ready(render(cfg, key=jax.random.PRNGKey(i)))
        with prof.phase("colorize"):
            img8 = jax.block_until_ready(colorize8(state))
        with prof.phase("fetch"):
            fetch_image(img8)
        phase_runs.append({k: round(v, 4) for k, v in prof.phases.items()})

    # re-learn the lit bbox from a full-workload render, untimed
    for _ in range(2):
        warm_banded = colorize_convert_fetch(cfg, state, transparent=False, eight_bit=True)
    np.testing.assert_array_equal(warm_banded, fetch_image(colorize8(state)))

    wall_runs = []
    for i in range(wall_attempts):
        t0 = time.perf_counter()
        state = render(cfg, key=jax.random.PRNGKey(100 + i))
        img8_host = colorize_convert_fetch(cfg, state, transparent=False, eight_bit=True)
        wall_runs.append(round(time.perf_counter() - t0, 4))

    assert img8_host.shape == assert_shape and img8_host.dtype == np.uint8
    assert img8_host.max() > 0
    renders = [r["render"] for r in phase_runs]
    return {
        "value": round(executed / statistics.median(renders), 1),
        "runs": [round(executed / r, 1) for r in renders],
        "wall_s": round(statistics.median(wall_runs), 4),
        "wall_runs": wall_runs,
        "phases": {k: round(statistics.median(r[k] for r in phase_runs), 4)
                   for k in phase_runs[0]},
        "phase_runs": phase_runs,
        "iterations": executed,
        "_state": state,
    }


def main() -> int:
    import jax
    import numpy as np

    from strange_attractor_tpu import colorize, presets
    from strange_attractor_tpu.certify import certify_binning, emission_stream
    from strange_attractor_tpu.config import BrightnessConstants, Colors
    from strange_attractor_tpu.render import colorize_convert_fetch
    from strange_attractor_tpu.utils.export import convert_format_device, fetch_image
    from strange_attractor_tpu.utils.profiling import enable_compilation_cache

    devices = jax.devices()
    dev = devices[0]
    cpu_requested = os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"
    if dev.platform != "gpu" and not cpu_requested:
        print(f"bench: needs a GPU, JAX found {dev.platform} (set JAX_PLATFORMS=cpu "
              "for a CPU rehearsal)", file=sys.stderr)
        return 1
    print(f"bench: {dev.platform} {dev.device_kind} x {len(devices)}", file=sys.stderr)
    enable_compilation_cache()

    on_gpu = dev.platform == "gpu"
    iterations = int(float(os.environ.get("BENCH_ITERS", "1e9" if on_gpu else "2e6")))

    def workload(preset, w, h, b):
        return preset(iterations=iterations, width=w, height=h, seed=0, silent=True,
                      colors=Colors(brightness=BrightnessConstants(offset=b)))

    cfg = workload(presets.poisson_saturne, 1920, 1080, -0.25)

    # certify every strategy on this device before timing anything, at the
    # production section sizes
    n = 1 << (20 if on_gpu else 14)
    flat, z, val = emission_stream(cfg, n, seed=0)
    certify_binning(cfg.width, cfg.height, flat, z, val, log=lambda *_: None)
    cert = f"all strategies match the oracle ({n} pts)"

    flagship = _measure(cfg, phase_attempts=3, wall_attempts=5, assert_shape=(1080, 1920, 3))
    state = flagship.pop("_state")

    # the same end to end with the reference CLI's default no-flag
    # deliverable (16-bit RGB), through the same banded delivery
    @jax.jit
    def colorize16(st):
        return convert_format_device(colorize(cfg, st), False, False)

    warm16 = fetch_image(colorize16(state))
    for _ in range(2):
        np.testing.assert_array_equal(
            colorize_convert_fetch(cfg, state, transparent=False, eight_bit=False), warm16)
    tail16 = []
    for _ in range(3):
        t0 = time.perf_counter()
        img16 = colorize_convert_fetch(cfg, state, transparent=False, eight_bit=False)
        tail16.append(time.perf_counter() - t0)
    assert img16.shape == (1080, 1920, 3) and img16.dtype == np.uint16

    solar = _measure(workload(presets.solar_sail, 1800, 2000, -0.1),
                     phase_attempts=3, wall_attempts=3, assert_shape=(2000, 1800, 3))
    solar.pop("_state")
    solar["value_unit"] = "iters/s"
    solar["deliverable"] = "8-bit RGB frame on host (10.8 MB)"

    record = {
        "metric": "map iterations/sec",
        "value": flagship["value"],
        "unit": "iters/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(devices)},
        **{k: flagship[k] for k in ("runs", "wall_s", "wall_runs", "phases", "phase_runs")},
        "deliverable": "8-bit RGB frame on host (reference --8-bit path)",
        "wall_16bit_rgb_s": round(flagship["phases"]["render"] + statistics.median(tail16), 4),
        "binning_cert": cert,
        "iterations": flagship["iterations"],
        "solar_sail": solar,
    }
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
