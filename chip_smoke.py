"""The quickest proof that the renderer's main path runs on a GPU.

    python chip_smoke.py               # one GPU: phases 1-5
    python chip_smoke.py --four-cards  # four GPUs: the sharded phase only

Everything runs in this one process (a second JAX process could not get
the card's memory), through the entry points a user calls: ``cli.main``
for renders, ``render``/``colorize`` for the library path. Phases:

1. every bin strategy on 2^22 real emitted points (plus a pixel-0 flood)
   on a 1920x1080 canvas, against ``oracle.oracle_bin`` on the host;
2. a short-horizon 1920x1080 render against ``oracle.oracle_render``;
3. the flagship through the CLI (poisson-saturne, 1e9 iterations, 1080p),
   and the device tone map against ``oracle.oracle_colorize``;
4. solar-sail at 1e9 / 1800x2000, and a depth + 16-bit + transparent export;
5. rotation sequences with per-frame and shared orbits.

``--four-cards`` renders the flagship sharded over four GPUs, compares it
with a one-GPU render of the same budget, and runs the 2x2 (frames x lanes)
sequence mesh. The script exits non-zero, printing no result line, when
JAX finds no GPU or any phase fails. Its last stdout line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

FLAGSHIP = ["-i", "1000000000", "-w", "1920", "-h", "1080", "-b", "-0.25", "-8", "-q"]
SOLAR = ["-p", "solar-sail", "-i", "1000000000", "-w", "1800", "-h", "2000",
         "-b", "-0.1", "-8", "-q"]
DEPTH = ["--depth", "-a", "220", "-p", "solar-sail", "-t", "-q"]
SEQUENCE = ["-8", "-q"]
# agreement bar of the short-horizon oracle check (cli.doctor's)
AGREEMENT_BAR = 0.98


def _expect(ok, what):
    """A phase check that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def _png(path, shape, dtype):
    """Decode a written PNG and check its shape, type and that it is lit."""
    import numpy as np

    from strange_attractor_tpu.utils.export import read_png

    with open(path, "rb") as f:
        img = read_png(f.read())
    _expect(img.shape == shape and img.dtype == dtype, (path, img.shape, img.dtype))
    _expect(img[..., :3].max() > 0, f"{path} is blank")
    lit = float((img[..., :3].max(axis=-1) > 0).mean())
    return img, lit


def _config(argv):
    from strange_attractor_tpu import cli

    return cli.config_from_args(cli.build_parser().parse_args(list(argv)))


def _cli(argv):
    from strange_attractor_tpu import cli

    t0 = time.perf_counter()
    rc = cli.main(argv)
    _expect(rc == 0, f"cli.main({argv}) returned {rc}")
    return time.perf_counter() - t0


def phase_binning(n=1 << 22, width=1920, height=1080):
    """Every strategy, compiled for this device, against the host oracle."""
    from strange_attractor_tpu import presets
    from strange_attractor_tpu.certify import certify_binning, emission_stream

    cfg = presets.poisson_saturne(width=width, height=height)
    flat, z, val = emission_stream(cfg, n, seed=0)
    res = certify_binning(width, height, flat, z, val)
    return (f"{n} pts on {width}x{height}, production sections: all strategies match; "
            f"EXACT steps differ from the oracle on {res['exact_steps_tie_pixels']} px "
            "(within-chunk z ties only)")


def phase_oracle_render(width=1920, height=1080, lanes=256, chunk_steps=64, nchunks=4):
    """Short-horizon render vs the numpy oracle, as cli.doctor checks it:
    visited-pixel count agreement after the 100-step warm-up."""
    import jax
    import numpy as np

    from strange_attractor_tpu import presets
    from strange_attractor_tpu.config import BinStrategy
    from strange_attractor_tpu.oracle import oracle_render
    from strange_attractor_tpu.render import plan_schedule, render, seed_key

    cfg = presets.poisson_saturne(
        width=width, height=height, lanes=lanes, chunk_steps=chunk_steps,
        iterations=lanes * chunk_steps * nchunks, warmup=100, seed=7,
        bin_strategy=BinStrategy.EXACT,
    )
    key = seed_key(cfg)
    l, chunk, nch = plan_schedule(cfg)
    seeds = np.asarray(jax.random.uniform(key, (l, 3), dtype="float32") * 0.1)
    count = np.asarray(render(cfg, key=key).count)
    oc, _, _ = oracle_render(cfg, seeds, steps_per_lane=chunk * nch)
    visited = (count > 0) | (oc > 0)
    agree = float((count == oc)[visited].mean())
    note = (f"warm-up 100 + {chunk * nch} steps x {l} lanes: counts agree on "
            f"{agree:.4%} of {int(visited.sum())} visited px")
    _expect(agree >= AGREEMENT_BAR, note)
    return note


def phase_flagship(tmp, argv=FLAGSHIP):
    """The flagship through the CLI, then the library path's tone map
    against the oracle's."""
    import jax
    import numpy as np

    from strange_attractor_tpu import colorize, render
    from strange_attractor_tpu.oracle import oracle_colorize
    from strange_attractor_tpu.render import plan_schedule

    cfg = _config(argv)
    out = os.path.join(tmp, "attractor")
    wall = _cli(list(argv) + ["-o", out])
    _, lit = _png(out + ".png", (cfg.height, cfg.width, 3), np.uint8)

    lanes, chunk, nchunks = plan_schedule(cfg)
    executed = lanes * chunk * nchunks
    jax.block_until_ready(render(cfg))  # compiled by the CLI run already
    t0 = time.perf_counter()
    state = jax.block_until_ready(render(cfg))
    dt = time.perf_counter() - t0
    img = np.asarray(jax.device_get(colorize(cfg, state)))
    count, steps, zbuf = (np.asarray(p) for p in jax.device_get(
        (state.count, state.steps, state.zbuf)))
    want = oracle_colorize(cfg, count, steps, zbuf)
    diff = np.abs(img.astype(np.int64) - want.astype(np.int64))
    # the device tone map runs in f32, the oracle in f64: the two can round
    # a channel to neighbouring u16 values, never further apart
    _expect(diff.max() <= 1, f"colorize differs from the oracle by {diff.max()} LSB")
    return (f"CLI wall {wall:.2f}s (compile included), PNG {cfg.height}x{cfg.width}x3 u8, "
            f"{lit:.1%} lit; render {executed:.3e} iters in {dt:.3f}s = "
            f"{executed / dt:.4e} iters/s; colorize vs oracle: max "
            f"{int(diff.max())} LSB, {int((diff > 0).sum())} of {diff.size} "
            "channel values differ")


def phase_solar(tmp, argv=SOLAR, depth_argv=DEPTH):
    """Solar-sail's escaping-orbit flood, then the depth export."""
    import numpy as np

    cfg, dcfg = _config(argv), _config(depth_argv)
    out = os.path.join(tmp, "solar")
    wall = _cli(list(argv) + ["-o", out])
    _, lit = _png(out + ".png", (cfg.height, cfg.width, 3), np.uint8)
    depth = os.path.join(tmp, "depth")
    dwall = _cli(list(depth_argv) + ["-o", depth])
    img, dlit = _png(depth + ".png", (dcfg.height, dcfg.width, 4), np.uint16)
    _expect((img[..., 3] == 65535).all(), "depth alpha must be opaque")
    return (f"solar-sail {cfg.iterations:.0e} {cfg.width}x{cfg.height}: CLI wall "
            f"{wall:.2f}s, {lit:.1%} lit; depth 16-bit RGBA export: wall "
            f"{dwall:.2f}s, {dlit:.1%} lit")


def phase_sequence(tmp, argv=SEQUENCE):
    """Rotation sequences, per-frame and shared orbits."""
    import numpy as np

    cfg = _config(argv)
    notes = []
    for orbit in ("per-frame", "shared"):
        base = os.path.join(tmp, f"seq-{orbit}")
        wall = _cli(list(argv) + ["-o", base, "sequence", "-s", "0", "-e", "3", "-d", "1",
                                  "--frames-per-batch", "2", "--orbit", orbit])
        frames = [_png(f"{base}{i}.png", (cfg.height, cfg.width, 3), np.uint8)[0]
                  for i in range(3)]
        for i in range(1, 3):
            _expect(not np.array_equal(frames[0], frames[i]), f"{orbit}: frames 0 and {i} equal")
        notes.append(f"{orbit}: 3 distinct frames in {wall:.2f}s")
    return "; ".join(notes)


def phase_four_cards(tmp, devices=None, argv=FLAGSHIP):
    """The flagship sharded over four cards through the CLI, against a
    one-card render of the same budget; then the 2x2 sequence mesh."""
    import jax
    import numpy as np

    from strange_attractor_tpu import render
    from strange_attractor_tpu.parallel.mesh import render_sequence_sharded, render_sharded
    from strange_attractor_tpu.runtime import load_state

    devices = list(devices or jax.devices()[:4])
    _expect(len(devices) == 4, devices)
    out = os.path.join(tmp, "sharded")
    saved = os.path.join(tmp, "sharded.npz")
    wall = _cli(list(argv) + ["-o", out, "--save-state", saved])
    cfg = _config(argv)
    h, w = cfg.height, cfg.width
    _png(out + ".png", (h, w, 3), np.uint8)
    sharded = load_state(saved)

    # the per-device canvases must sit on four distinct cards
    st4 = render_sharded(cfg, devices)
    shard_devs = {s.device for s in st4.count.addressable_shards}
    _expect(shard_devs == set(devices), shard_devs)

    with jax.default_device(devices[0]):
        single = render(cfg)
    c4 = np.asarray(sharded.count).astype(np.float64)
    c1 = np.asarray(jax.device_get(single.count)).astype(np.float64)
    rel = abs(c4.sum() - c1.sum()) / max(c1.sum(), 1.0)
    _expect(rel < 0.05, f"sample budgets diverge ({rel:.3f})")
    lit4, lit1 = c4 > 0, c1 > 0
    iou = (lit4 & lit1).sum() / max(1, (lit4 | lit1).sum())
    _expect(iou > 0.6, f"lit-pixel IoU vs one card = {iou:.3f}")

    notes = [f"CLI on 4 cards: wall {wall:.2f}s; count sums within {rel:.2%}; "
             f"lit IoU {iou:.4f}; shards on {len(shard_devs)} cards"]
    seq_cfg = cfg.replace(iterations=10_000_000)
    for orbit in ("per-frame", "shared"):
        frames = render_sequence_sharded(seq_cfg, [0.0, 120.0, 240.0, 300.0], devices,
                                         frame_axis=2, orbit=orbit, eight_bit=True,
                                         transparent=False)
        _expect(frames.shape == (4, h, w, 3) and frames.max() > 0, frames.shape)
        _expect(not np.array_equal(frames[0], frames[1]), f"{orbit}: angles must differ")
        notes.append(f"2x2 sequence mesh ({orbit}): 4 distinct frames")
    return "; ".join(notes)


def _run(name, fn, *args):
    t0 = time.perf_counter()
    try:
        detail = fn(*args)
    except Exception:  # noqa: BLE001 — report every phase, fail at the end
        traceback.print_exc()
        print(f"phase {name}: FAIL ({time.perf_counter() - t0:.1f}s)", flush=True)
        return False
    print(f"phase {name}: ok ({time.perf_counter() - t0:.1f}s) {detail}", flush=True)
    return True


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    try:
        import jax

        from strange_attractor_tpu.utils.profiling import enable_compilation_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the renderer ({e}); run it from the "
              "repository root", file=sys.stderr)
        return 2
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}", file=sys.stderr)
        return 1
    if four and len(devices) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devices)}", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}", flush=True)
    enable_compilation_cache()

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        if four:
            phases = [("four-cards", phase_four_cards, tmp)]
        else:
            phases = [
                ("1 binning", phase_binning),
                ("2 oracle-render", phase_oracle_render),
                ("3 flagship", phase_flagship, tmp),
                ("4 solar-sail", phase_solar, tmp),
                ("5 sequence", phase_sequence, tmp),
            ]
        ok = all([_run(name, fn, *args) for name, fn, *args in phases])
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
