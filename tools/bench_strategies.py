"""Time each sort-bin strategy against its scatter twin on the current device.

Renders the two reference workloads (poisson-saturne 1920x1080 brightness
-0.25, README.md:72-73; solar-sail 1800x2000 brightness -0.1,
README.md:74-75) with every bin strategy and prints one JSON line per
(workload, strategy). The pairs run in turns — sort-bin, scatter, scatter,
sort-bin — so both sides of a pair see the same card state; each line
carries its two render times (``block_until_ready``, compile excluded).

    python tools/bench_strategies.py [iterations] [--sections 15,17,19]

``iterations`` defaults to 1e9 on a GPU and to a token 2e6 elsewhere.
``--sections`` runs, instead of the pairs, a section-size sweep (log2
points per sorted section) of KERNEL and EXACT_KERNEL on both workloads.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import jax

    from strange_attractor_tpu.config import (
        BinStrategy as B,
        BrightnessConstants,
        Colors,
        RenderKind,
    )
    from strange_attractor_tpu.models import presets
    from strange_attractor_tpu.render import plan_schedule, precompile, render
    from strange_attractor_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    sections = []
    if "--sections" in sys.argv:
        sections = [int(s) for s in sys.argv[sys.argv.index("--sections") + 1].split(",")]
        args = [a for a in args if a != sys.argv[sys.argv.index("--sections") + 1]]
    dev = jax.devices()[0]
    budget = int(float(args[0])) if args else int(1e9 if dev.platform == "gpu" else 2e6)
    workloads = [
        ("poisson-saturne 1920x1080 b-0.25", presets.poisson_saturne, 1920, 1080, -0.25),
        ("solar-sail 1800x2000 b-0.1", presets.solar_sail, 1800, 2000, -0.1),
    ]
    # (sort-bin, scatter twin or None, render kind, exact16 ties, x64)
    pairs = [
        (B.KERNEL, B.PACKED, RenderKind.GAS, "value", False),
        (B.DEPTH_KERNEL, B.DEPTH, RenderKind.DEPTH, "value", False),
        (B.EXACT_KERNEL, B.EXACT, RenderKind.GAS, "value", False),
        (B.EXACT16_KERNEL, None, RenderKind.GAS, "value", False),
        (B.EXACT16_KERNEL, None, RenderKind.GAS, "earliest", True),
    ]

    def timed(cfg, x64):
        with jax.enable_x64(x64):
            jax.block_until_ready(render(cfg, key=jax.random.PRNGKey(0)))
            t0 = time.perf_counter()
            jax.block_until_ready(render(cfg, key=jax.random.PRNGKey(1)))
            return time.perf_counter() - t0

    def emit(workload, cfg, times, **extra):
        lanes, chunk, nchunks = plan_schedule(cfg)
        executed = lanes * chunk * nchunks
        print(json.dumps({
            "workload": workload, "strategy": cfg.bin_strategy.value, **extra,
            "iterations": executed, "render_s": [round(t, 4) for t in times],
            "iters_per_sec": round(executed / min(times), 1),
            "device": {"platform": dev.platform, "kind": dev.device_kind},
        }), flush=True)

    for name, preset, w, h, b in workloads if not sections else []:
        for sortbin, twin, kind, ties, x64 in pairs:
            cfgs = [preset(iterations=budget, width=w, height=h, render=kind, seed=0,
                           silent=True, bin_strategy=s, exact16_ties=ties,
                           colors=Colors(brightness=BrightnessConstants(offset=b)))
                    for s in (sortbin, twin) if s is not None]
            for cfg in cfgs:
                with jax.enable_x64(x64):
                    precompile(cfg)
            order = [0, 1, 1, 0] if len(cfgs) == 2 else [0, 0]
            times = [[] for _ in cfgs]
            for i in order:
                times[i].append(timed(cfgs[i], x64))
            for cfg, t in zip(cfgs, times):
                extra = {"ties": ties} if cfg.bin_strategy is B.EXACT16_KERNEL else {}
                emit(name, cfg, t, **extra)

    for name, preset, w, h, b in workloads if sections else []:
        for log2 in sections:
            for strategy in (B.KERNEL, B.EXACT_KERNEL):
                cfg = preset(iterations=budget, width=w, height=h, seed=0, silent=True,
                             bin_strategy=strategy, kernel_section=1 << log2,
                             colors=Colors(brightness=BrightnessConstants(offset=b)))
                precompile(cfg)
                emit(name, cfg, [timed(cfg, False), timed(cfg, False)], section_log2=log2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
