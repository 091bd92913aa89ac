"""Pixel-parity check against the reference's published render.

The reference repo ships ``media/poisson-saturne.png`` — its own 10^9
iteration, brightness -0.25, 1920x1080 output (README.md:72-73). This tool
renders the identical workload here and reports tone-mapped agreement, the
BASELINE.json acceptance criterion ("pixel-matching the Rust output within
tone-map tolerance"). The H100 figure is not measured yet: the reference
PNG is not part of this repository (docs/PARITY.md).

Usage:  python tools/compare_reference.py --reference PNG [--out PNG] [--reuse]

By default the workload is re-rendered every run (the metric must reflect the
current code); pass --reuse to compare an existing --out file instead.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def _rgb8(path: str) -> np.ndarray:
    from strange_attractor_tpu.utils.export import read_png

    with open(path, "rb") as f:
        img = read_png(f.read())[..., :3]
    if img.dtype == np.uint16:
        img = ((img.astype(np.uint32) * 255 + 32767) // 65535).astype(np.uint8)
    return img.astype(np.float64)


def compare(ref_path: str, our_path: str) -> dict:
    ref, ours = _rgb8(ref_path), _rgb8(our_path)
    if ref.shape != ours.shape:
        raise SystemExit(f"shape mismatch: {ref.shape} vs {ours.shape}")
    mad = float(np.abs(ref - ours).mean() / 255)
    corr = float(np.corrcoef(ref.ravel(), ours.ravel())[0, 1])
    rs, os_ = ref.max(-1) > 8, ours.max(-1) > 8
    iou = float((rs & os_).sum() / max(1, (rs | os_).sum()))
    return {"mad": mad, "correlation": corr, "support_iou": iou}


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reference", required=True,
                    help="the reference repository's media/poisson-saturne.png")
    ap.add_argument("--out", default="parity_render.png")
    ap.add_argument("--reuse", action="store_true",
                    help="compare an existing --out file instead of re-rendering")
    ap.add_argument("--bin-strategy", default="auto",
                    # no depth/depth-kernel: the parity target is the
                    # reference's published GAS PNG, and a z-only state
                    # cannot be colorized as gas (the render would complete
                    # and then fail in colorize)
                    choices=["auto", "exact", "packed", "kernel",
                             "exact-kernel", "exact16-kernel"],
                    help="accumulation strategy for the parity render "
                         "(records each strategy's own parity figure)")
    args = ap.parse_args()
    ref = args.reference
    out = Path(args.out)
    if not (args.reuse and out.exists()):
        import time

        from strange_attractor_tpu import colorize, presets, render
        from strange_attractor_tpu.config import BinStrategy, BrightnessConstants, Colors
        from strange_attractor_tpu.render import plan_schedule, precompile
        from strange_attractor_tpu.utils.export import write_image
        from strange_attractor_tpu.utils.profiling import enable_compilation_cache
        import jax

        enable_compilation_cache()
        cfg = presets.poisson_saturne(
            iterations=1_000_000_000,
            colors=Colors(brightness=BrightnessConstants(offset=-0.25)),
            seed=0,
            silent=False,
            bin_strategy=BinStrategy(args.bin_strategy),
        )
        precompile(cfg)
        t0 = time.perf_counter()
        state = jax.block_until_ready(render(cfg))
        lanes, chunk, nchunks = plan_schedule(cfg)
        dt = time.perf_counter() - t0
        print(f"[{args.bin_strategy}] {lanes * chunk * nchunks / dt:.3e} iters/s ({dt:.2f}s)")
        img = np.asarray(jax.device_get(colorize(cfg, state)))
        out = write_image(out.with_suffix(""), img, fmt="png", transparent=False, eight_bit=True)
    metrics = compare(ref, str(out))
    print(metrics)
    ok = metrics["mad"] < 0.01 and metrics["correlation"] > 0.99
    print("PARITY: PASS" if ok else "PARITY: FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
