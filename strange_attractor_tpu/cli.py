"""Command-line interface mirroring the reference binary's flag surface
(src/bin/main.rs:178-408) plus accelerator tuning flags.

Deviations from the reference (all documented SURVEY.md §7 fixes):

- ``--single-thread`` is long-only: the reference accidentally declared
  ``-s`` for both ``--scale`` and ``--single-thread`` (main.rs:237/286).
  Here ``--single-device`` replaces it (there is no thread pool to size);
  ``--single-thread`` is kept as an alias.
- ``-a/--angle`` degrees are converted to radians for single frames too; the
  reference's single-frame path passed degrees through unconverted
  (main.rs:169-171, 475-478).
- ``-h`` selects ``--height`` like the reference (help is ``--help`` only,
  main.rs:186-187).
"""

from __future__ import annotations

import argparse
import sys
import threading
from pathlib import Path

import numpy as np

from .config import BrightnessConstants, Colors, Palette, RenderKind
from .models import presets
from .utils.sequencing import frame_sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="strange-attractor-renderer-tpu",
        description="Strange-attractor renderer on JAX.",
        add_help=False,
    )
    p.add_argument("--help", action="help", help="Print help")
    p.add_argument("--depth", action="store_true", help="output depth information")
    p.add_argument("-8", "--8-bit", dest="eight_bit", action="store_true",
                   help="Write image in an 8-bit format")
    p.add_argument("-t", "--transparent", action="store_true",
                   help="Add transparency to the image")
    p.add_argument("-i", "--iterations", type=int, default=10_000_000,
                   help="Number of iterations")
    p.add_argument("-w", "--width", type=int, default=1920, help="Width of image")
    p.add_argument("-h", "--height", type=int, default=1080, help="Height of image")
    p.add_argument("-s", "--scale", type=float, default=None,
                   help="Image zoom (default: the preset's own scale). The reference "
                        "CLI always overrode the preset with 1.0 (main.rs:237/437), "
                        "silently stomping solar-sail's 1.7 — fixed here.")
    p.add_argument("-p", "--preset", choices=list(presets.PRESET_NAMES),
                   default="poisson-saturne", help="Which built-in attractor to render")
    # custom polynomial Sprott coefficients (the reference requires writing
    # Rust against the Attractor trait for this; chaoscope publishes such
    # coefficient sets). Each takes the 10 monomial coefficients for
    # [1, x, x^2, xy, xz, y, y^2, yz, z, z^2].
    p.add_argument("--coeffs-x", dest="coeffs_x", type=float, nargs=10, default=None,
                   metavar="C", help="Custom attractor: 10 x-row coefficients")
    p.add_argument("--coeffs-y", dest="coeffs_y", type=float, nargs=10, default=None,
                   metavar="C", help="Custom attractor: 10 y-row coefficients")
    p.add_argument("--coeffs-z", dest="coeffs_z", type=float, nargs=10, default=None,
                   metavar="C", help="Custom attractor: 10 z-row coefficients")
    p.add_argument("--camera", type=float, nargs=3, default=None, metavar="V",
                   help="Custom attractor: center_camera x y z (default: preset's)")
    p.add_argument("--rotation-axis", dest="rotation_axis", type=float, nargs=4,
                   default=None, metavar="V",
                   help="Custom attractor: rotation axis x y z + angle (radians)")
    p.add_argument("--pam", "--pnm", "--pbm", dest="pam", action="store_true",
                   help="Use PAM format, a bitmap-like format. 16-bit images are not supported.")
    p.add_argument("--bmp", "--bitmap", dest="bmp", action="store_true",
                   help="Use BMP format. 16-bit images are not supported.")
    p.add_argument("-o", "--file-name", dest="name", default="attractor",
                   help="Write to file name")
    p.add_argument("--single-device", "--single-thread", dest="single_device",
                   action="store_true", help="Run on a single device")
    p.add_argument("--distributed", action="store_true",
                   help="Multi-host rendering: bring up jax.distributed before "
                        "touching devices (auto-detects SLURM / MPI "
                        "environments; launch the same command on every host). "
                        "Only the primary process writes output files.")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="Explicit jax.distributed coordinator address (implies "
                        "--distributed; also pass --num-processes/--process-id)")
    p.add_argument("--num-processes", dest="num_processes", type=int, default=None,
                   help="Total process count for --coordinator bring-up")
    p.add_argument("--process-id", dest="process_id", type=int, default=None,
                   help="This process's index for --coordinator bring-up")
    p.add_argument("-q", "--silent", action="store_true", help="Decrease verbosity")
    p.add_argument("-j", "--jobs-per-thread", dest="jobs_per_thread", type=int, default=None,
                   help="Accepted for reference-CLI compatibility; device work "
                        "scheduling is static (SPMD lanes), so this has no effect. "
                        "Use --lanes/--chunk-steps to tune instead. Conflicts with "
                        "--single-device, like the reference (main.rs:297-306). "
                        "(default: 12)")
    p.add_argument("-a", "--angle", type=float, default=0.0,
                   help="Angle to view attractor from (degrees)")
    p.add_argument("-b", "--brightness-offset", dest="brightness_offset", type=float,
                   default=-0.15,
                   help="Offset the brightness. You generally want to decrease this if "
                        "you have > 1e8 iterations.")
    p.add_argument("--palette", default=None, metavar="STOPS",
                   help="Custom palette: semicolon-separated r,g,b stops in [0,1], "
                        "e.g. '1,1,.5;.5,1,.5;1,.5,.5' (default: the reference's "
                        "6-stop table; interpolation clamps + sqrt per channel)")
    # accelerator tuning (no reference counterpart)
    p.add_argument("--lanes", type=int, default=None,
                   help="Parallel trajectory lanes (default: auto from iterations)")
    p.add_argument("--chunk-steps", type=int, default=None,
                   help="Map steps per binning flush (default: auto)")
    p.add_argument("--bin-strategy",
                   choices=["auto", "exact", "packed", "depth", "kernel", "exact-kernel",
                            "exact16-kernel", "depth-kernel"],
                   default="auto",
                   help="Canvas accumulation strategy. 'auto' picks 'exact' "
                        "(full-f32 reference-faithful scatter path); "
                        "kernel/packed quantize depth to ~2^-11 relative and the "
                        "palette position to 1/4096 — 'kernel' and the other "
                        "*-kernel strategies sort each point chunk by pixel "
                        "before touching the canvas: 'exact-kernel' is "
                        "full-f32 reference-faithful, 'exact16-kernel' keeps the "
                        "strict z-test at 16-bit z granularity, 'depth-kernel' "
                        "accumulates only the z-buffer")
    p.add_argument("--exact16-ties", dest="exact16_ties",
                   choices=["value", "earliest"], default="value",
                   help="exact16-kernel bucket-tie discipline: 'value' (smallest "
                        "f16 value of the top z bucket; an unstable 2-operand "
                        "sort) or 'earliest' (first-emitted, the reference's "
                        "stream-order rule, via a stable or u64-keyed sort)")
    p.add_argument("--seed", type=int, default=None, help="Deterministic RNG seed")
    p.add_argument("--reseed-lanes", dest="reseed_lanes", action="store_true",
                   help="Resurrect trajectory lanes whose orbit escaped to infinity "
                        "(more samples/sec for escaping coefficient sets like "
                        "solar-sail; off replicates the reference's behavior)")
    p.add_argument("--save-state", default=None, metavar="PATH",
                   help="Checkpoint the accumulator state to PATH (.npz) after rendering")
    p.add_argument("--load-state", default=None, metavar="PATH",
                   help="Resume accumulation from a checkpointed state (.npz)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Write a jax.profiler trace to DIR")
    p.add_argument("--preview-every", dest="preview_every", type=float, default=0.0,
                   metavar="SECONDS",
                   help="During long renders, write a '<name>-preview' image at this "
                        "interval showing the ever-improving accumulation "
                        "(single-device renders only)")

    sub = p.add_subparsers(dest="subcommand")
    seq = sub.add_parser(
        "sequence",
        help="Render a sequence of frames rotating around the attractor.",
        description="Render a sequence of frames rotating around the attractor.\n"
        "All the arguments passed before this subcommand are used when creating the images.",
        add_help=False,
    )
    seq.add_argument("--help", action="help", help="Print help")
    seq.add_argument("-s", "--start", type=float, default=0.0,
                     help="The angle to start the animation from (degrees)")
    seq.add_argument("-e", "--end", type=float, default=360.0,
                     help="The angle to end the animation at (degrees)")
    seq.add_argument("-d", "--step", type=float, default=0.5,
                     help="Amount to change the angle for each frame (degrees)")
    seq.add_argument("--frames-per-batch", dest="frames_per_batch", type=int, default=0,
                     help="Render this many frames per device program as a vmapped "
                          "batch (0 = serial frames). Best for many small frames.")
    seq.add_argument("--orbit", choices=["per-frame", "shared"], default="per-frame",
                     help="'per-frame' (default) draws fresh trajectory samples "
                          "for every frame like the reference; 'shared' bins one "
                          "orbit per batch — sampling noise moves coherently "
                          "with the camera instead of re-rolling per frame (no "
                          "temporal sparkle), each frame bit-identical to a "
                          "single render of that orbit, device memory stays "
                          "bounded by ONE frame's point buffers, and the warm-up "
                          "+ map loop run once per batch. Needs "
                          "--frames-per-batch > 0; on a device mesh each "
                          "frames-row shares one orbit (lanes split across "
                          "the row).")
    seq.add_argument("--apng", action="store_true",
                     help="Write the whole sequence as one animated PNG "
                          "('<name>.apng') instead of per-frame files")
    seq.add_argument("--fps", type=float, default=30.0,
                     help="Playback rate for --apng")

    doc = sub.add_parser("doctor", help="Run environment self-checks "
                         "(device, correctness vs the numpy oracle, throughput)",
                         add_help=False)
    doc.add_argument("--help", action="help", help="Print help")

    comp = sub.add_parser("completion", help="Generate a shell completion script",
                          add_help=False)
    comp.add_argument("--help", action="help", help="Print help")
    comp.add_argument("--shell", choices=["bash", "zsh", "fish"], default="bash")
    comp.add_argument("--print", dest="print_only", action="store_true", default=True,
                      help="Print the script to stdout (default)")
    comp.add_argument("--install", action="store_true",
                      help="Write the script to the per-user completion dir "
                           "(no root needed, unlike the reference's system-dir "
                           "install)")
    # the "-8" short flag makes argparse refuse bare negative values like
    # ``-b -0.25`` (the reference sets allow_hyphen_values, main.rs:314/324);
    # "-8" itself still wins by exact option match.
    p._has_negative_number_optionals.clear()  # noqa: SLF001
    seq._has_negative_number_optionals.clear()  # noqa: SLF001
    return p


def _validate(args, parser):
    # mutual exclusion mirrors the reference's clap conflicts_with
    # (main.rs:297-306); only an *explicitly passed* -j conflicts, hence
    # the None default standing in for the documented 12
    if args.jobs_per_thread is not None and args.single_device:
        parser.error("-j/--jobs-per-thread conflicts with --single-device")
    if args.jobs_per_thread is not None and args.jobs_per_thread < 1:
        parser.error("-j/--jobs-per-thread must be a positive integer "
                     "(the reference parses NonZeroUsize)")
    if args.jobs_per_thread is None:
        args.jobs_per_thread = 12
    if args.coordinator and (args.num_processes is None or args.process_id is None):
        parser.error("--coordinator requires --num-processes and --process-id")
    if (args.pam or args.bmp) and not args.eight_bit:
        parser.error("--pam/--bmp require --8-bit (16-bit images are not supported)")
    if args.pam and args.bmp:
        parser.error("--pam conflicts with --bmp")
    if args.subcommand == "sequence" and args.end <= args.start:
        parser.error("sequence end must be after start")
        # matches the reference's InvalidValue error (main.rs:375-378)
    if args.subcommand == "sequence" and args.step <= 0:
        parser.error("step must be a positive")
    if (args.subcommand == "sequence" and args.orbit == "shared"
            and args.frames_per_batch <= 0):
        parser.error("--orbit shared renders whole batches from one orbit; "
                     "pass --frames-per-batch > 0")
    # a depth-only accumulation cannot be colorized as a Gas render (and a
    # Gas accumulation carries no z-plane for a depth render): reject the
    # mismatch at parse time instead of after the full render budget
    if args.bin_strategy in ("depth", "depth-kernel") and not args.depth:
        parser.error(f"--bin-strategy {args.bin_strategy} requires --depth "
                     "(it accumulates only the z-buffer)")
    if args.depth and args.bin_strategy in ("packed", "kernel"):
        parser.error(f"--bin-strategy {args.bin_strategy} cannot serve "
                     "--depth (it accumulates no z-buffer plane); use "
                     "auto, depth, depth-kernel, or a fidelity mode")
    args.palette_stops = None
    if args.palette:
        try:
            stops = [
                [float(c) for c in stop.split(",")]
                for stop in args.palette.split(";")
                if stop.strip()
            ]
            args.palette_stops = Palette(stops)  # validates shape/non-empty
        except (ValueError, TypeError) as e:
            parser.error(f"--palette: {e}")
        flat = [c for stop in stops for c in stop]
        if any(not 0.0 <= c <= 1.0 for c in flat):
            # out-of-range stops reach sqrt(negative) in the palette lerp
            # and render NaN->black with no error; the help documents [0,1]
            parser.error("--palette: components must be in [0, 1]")


def config_from_args(args):
    """Build a Config from CLI flags over the preset (main.rs:417-442)."""
    from .config import BinStrategy

    config = presets.by_name(args.preset)
    config = config.replace(
        iterations=args.iterations,
        width=args.width,
        height=args.height,
        transparent=args.transparent,
        silent=args.silent,
        colors=Colors(
            palette=getattr(args, 'palette_stops', None) or config.colors.palette,
            brightness=BrightnessConstants(offset=args.brightness_offset),
        ),
        render=RenderKind.DEPTH if args.depth else RenderKind.GAS,
        angle=float(np.radians(args.angle)),
        lanes=args.lanes,
        chunk_steps=args.chunk_steps,
        bin_strategy=BinStrategy(args.bin_strategy),
        exact16_ties=args.exact16_ties,
        seed=args.seed,
        reseed_lanes=args.reseed_lanes,
    )
    if args.scale is not None:
        config = config.replace(view=config.view.replace(scale=args.scale))

    # custom attractor overrides (coefficient rows default to the preset's)
    coeff_rows = (args.coeffs_x, args.coeffs_y, args.coeffs_z)
    if any(r is not None for r in coeff_rows):
        from .models.attractors import PolynomialSprott2Degree

        base = config.attractor
        if not isinstance(base, PolynomialSprott2Degree):
            base = PolynomialSprott2Degree(x=(0,) * 10, y=(0,) * 10, z=(0,) * 10)
        config = config.replace(
            attractor=PolynomialSprott2Degree(
                x=tuple(coeff_rows[0]) if coeff_rows[0] else base.x,
                y=tuple(coeff_rows[1]) if coeff_rows[1] else base.y,
                z=tuple(coeff_rows[2]) if coeff_rows[2] else base.z,
            )
        )
    if args.camera is not None:
        config = config.replace(
            view=config.view.replace(center_camera=tuple(args.camera))
        )
    if args.rotation_axis is not None:
        from .ops.projection import EulerAxisRotation

        ax = args.rotation_axis
        config = config.replace(
            view=config.view.replace(
                rotation=EulerAxisRotation(axis=(ax[0], ax[1], ax[2]), rotation=ax[3])
            )
        )
    return config


def _output_base(args) -> Path:
    """Output path stem handling (main.rs:445-457)."""
    path = Path(args.name)
    return path.parent / path.stem if path.stem else path.parent / "attractor"


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    _validate(args, parser)

    if getattr(args, "exact16_ties", "value") == "earliest":
        # the earliest-ties discipline rides a packed u64 sort key when
        # 64-bit types are enabled (ops/kernel_binning.py); nothing has
        # traced yet, so flipping the flag here is safe and the f32 render
        # path is x64-clean (the f64 escape hatch runs the same code)
        import jax

        jax.config.update("jax_enable_x64", True)

    if args.subcommand == "completion":
        from .utils.completion import completion_script, install_completion

        if args.install:
            path = install_completion(args.shell, parser)
            print(f"Installed {args.shell} completion to '{path}'.")
            if args.shell == "zsh":
                print(f"Ensure '{path.parent}' is on your fpath before compinit.")
        else:
            sys.stdout.write(completion_script(args.shell, parser))
        return 0

    if args.subcommand == "doctor":
        return doctor()

    if args.distributed or args.coordinator:
        # must run before anything touches the XLA backend
        from .parallel import distributed as dist

        args.distributed = True
        dist.initialize(args.coordinator, args.num_processes, args.process_id)
        if not dist.is_primary():
            # collective programs must run on every process, but only the
            # primary writes files; silence the others
            args.silent = True

    import importlib

    from .utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    render_mod = importlib.import_module(".render", __package__)
    from .runtime import load_state, save_state
    from .utils.export import write_image

    config = config_from_args(args)
    fmt = "pam" if args.pam else "bmp" if args.bmp else "png"
    base = _output_base(args)

    profile_ctx = None
    if args.profile:
        import jax

        profile_ctx = jax.profiler.trace(args.profile)
        profile_ctx.__enter__()

    def is_primary():
        """Under --distributed only process 0 writes outputs (the processes
        share a filesystem in the intended pod/NFS setups)."""
        if not args.distributed:
            return True
        import jax

        return jax.process_index() == 0

    encoders: list[threading.Thread] = []
    encoder_errors: list[BaseException] = []

    def write_async(image, path_base):
        """Overlap host-side encode with the next frame's device render
        (reference spawns an encoder thread per frame, main.rs:507-511).
        Bounded: at most 4 encoders in flight, so a long sequence cannot
        pile up hundreds of threads each pinning a fetched frame. Errors
        are collected and re-raised after the join — a failed write must
        not exit 0."""
        if not is_primary():
            return

        def encode():
            try:
                write_image(path_base, image, fmt=fmt,
                            transparent=args.transparent,
                            eight_bit=args.eight_bit, silent=config.silent)
            except BaseException as e:  # noqa: BLE001 — surfaced at join
                encoder_errors.append(e)

        while sum(t.is_alive() for t in encoders) >= 4:
            encoders[0].join()
            encoders.pop(0)
        t = threading.Thread(target=encode)
        t.start()
        encoders.append(t)

    try:
        if args.subcommand == "sequence":
            frames = list(frame_sequence(args.start, args.end, args.step, base))
            if args.frames_per_batch > 0:
                import jax

                if not args.single_device and len(jax.devices()) > 1:
                    # frames x lanes mesh: the multi-device analog of the
                    # vmapped batch (otherwise the whole batch would run on
                    # one device while the rest idle). --orbit shared maps
                    # to one orbit per frames-row (lanes split over the
                    # row's devices) — the mesh form of the single-device
                    # shared-orbit semantics.
                    from .parallel.mesh import render_sequence_sharded

                    images = render_sequence_sharded(
                        config,
                        [a for a, _ in frames],
                        transparent=args.transparent,
                        eight_bit=args.eight_bit,
                        # honor the user's per-program memory bound on the
                        # mesh path too (frames per DEVICE per program)
                        frames_per_batch=args.frames_per_batch,
                        orbit=args.orbit,
                    )
                else:
                    seq_fn = (render_mod.render_sequence_shared
                              if args.orbit == "shared"
                              else render_mod.render_sequence_batched)
                    images = seq_fn(
                        config,
                        [a for a, _ in frames],
                        frames_per_batch=args.frames_per_batch,
                        # deliverable conversion on device: the 8-bit RGB
                        # deliverable is 2.7x fewer bytes to copy to the host
                        # than u16 RGBA
                        transparent=args.transparent,
                        eight_bit=args.eight_bit,
                    )
            else:
                images = None
            if args.apng:
                from .utils.export import convert_format, write_apng

                if images is None:
                    import jax

                    base_key = render_mod.seed_key(config)
                    images = [
                        _render_one(args, config, render_mod,
                                    angle_rad=float(np.radians(a)),
                                    key=jax.random.fold_in(base_key, i))
                        for i, (a, _) in enumerate(frames)
                    ]
                if is_primary():
                    stack = np.stack(
                        [convert_format(im, args.transparent, args.eight_bit)
                         for im in images]
                    )
                    out = base.with_suffix(".apng")
                    write_apng(out, stack, fps=args.fps)
                    print(f"Wrote animation to '{out}'.")
            elif images is not None:
                for (angle_deg, out_path), image in zip(frames, images):
                    write_async(image, _strip_suffix(out_path))
            else:
                import jax

                # fold the frame index into one base key: a seeded config
                # would otherwise replay identical trajectories every frame
                # (matches render_sequence_batched's per-frame fold)
                base_key = render_mod.seed_key(config)
                for i, (angle_deg, out_path) in enumerate(frames):
                    image = _render_one(
                        args, config, render_mod,
                        angle_rad=float(np.radians(angle_deg)),
                        key=jax.random.fold_in(base_key, i),
                    )
                    write_async(image, _strip_suffix(out_path))
        else:
            state = load_state(args.load_state) if args.load_state else None
            image, state = _render_stateful(args, config, render_mod, state)
            if args.save_state and is_primary():
                save_state(args.save_state, state)
                if not config.silent:
                    print(f"Saved render state to '{args.save_state}'.")
            write_async(image, base)
    finally:
        for t in encoders:
            t.join()
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
    if encoder_errors:
        raise encoder_errors[0]
    return 0


def _strip_suffix(p):
    """Drop a filename extension so write_image's with_suffix can add the
    format's own (sequence frame names may carry one from -o)."""
    return p.parent / p.stem if p.suffix else p


def _render_one(args, config, render_mod, angle_rad, key=None):
    import jax

    if args.single_device or len(jax.devices()) <= 1:
        state = render_mod.render(config, None, key, angle=angle_rad)
    else:
        from .parallel.mesh import render_sharded

        state = render_sharded(config.replace(angle=angle_rad), key=key)
    # banded delivery: device-side deliverable conversion + u32-bitcast
    # fetch in row bands, each band's transfer overlapped with the next
    # band's tone-map (bit-identical to the plain colorize+convert+fetch;
    # render.colorize_convert_fetch)
    return render_mod.colorize_convert_fetch(
        config, state, transparent=args.transparent, eight_bit=args.eight_bit
    )


def _render_stateful(args, config, render_mod, state):
    import jax
    import time

    on_progress = None
    if args.preview_every > 0:
        from .utils.export import write_image

        # every process builds the callback (on a multi-process mesh the
        # grouped render and its per-group collective merge must run on all
        # of them); only the primary writes the preview file
        primary = not args.distributed or jax.process_index() == 0
        base = _output_base(args)
        last = [time.perf_counter()]

        def on_progress(done, total, partial):
            now = time.perf_counter()
            if now - last[0] < args.preview_every or not primary:
                return
            last[0] = now
            # banded + lit-bbox-cropped delivery of the CONVERTED preview
            # (write_image's convert_format is idempotent): repeated
            # previews of a growing accumulation are exactly the case the
            # crop cache serves — ~2.7x fewer bytes than the raw u16 RGBA
            # fetch before cropping, and the bbox rider re-learns as the
            # support grows
            img = render_mod.colorize_convert_fetch(
                config, partial,
                transparent=args.transparent, eight_bit=args.eight_bit)
            fmt = "pam" if args.pam else "bmp" if args.bmp else "png"
            # NB: no dot in the preview stem — write_image's with_suffix
            # would treat ".preview" as an extension and replace it,
            # silently overwriting the final output
            write_image(base.parent / (base.name + "-preview"), img, fmt=fmt,
                        transparent=args.transparent, eight_bit=args.eight_bit,
                        silent=True, announce=False)

    if not args.single_device and len(jax.devices()) > 1:
        from .parallel.mesh import render_sharded

        # standing checkpoints resume ON the mesh (merge-based; bit-exact
        # to continuing the accumulation) and previews work via grouped
        # dispatch — both single-device-only until round 5
        state = render_sharded(config, key=None, state=state,
                               on_progress=on_progress)
    else:
        state = render_mod.render(config, state, on_progress=on_progress)
    # banded delivery (render.colorize_convert_fetch): convert on device
    # before fetching (2.7x fewer bytes for the 8-bit-opaque case), fetch
    # through the u32-bitcast path, and overlap each row band's transfer
    # with the next band's tone-map — bit-identical output
    image = render_mod.colorize_convert_fetch(
        config, state, transparent=args.transparent, eight_bit=args.eight_bit
    )
    return image, state


def doctor() -> int:
    """Environment self-check: device, oracle agreement, throughput.

    The reference has no equivalent; this is the 'is my install sane' path
    for GPU and CPU hosts. The 98% visited-pixel agreement bar is a SMOKE
    threshold (accumulated float divergence over a real orbit is
    expected); the bit-exactness gates for the binning strategies are
    tests/test_kernel_binning.py and, on the GPU, chip_smoke.py.
    """
    import jax
    import numpy as np

    from .config import BinStrategy
    from .models import presets
    from .oracle import oracle_render
    from .render import colorize, plan_schedule, render, seed_key
    from .utils.native import get_lib
    from .utils.profiling import RenderProfile, enable_compilation_cache

    enable_compilation_cache()
    ok = True
    print(f"backend: {jax.default_backend()}  devices: {jax.devices()}")
    print(f"native parallel-deflate: {'available' if get_lib() else 'unavailable (stdlib zlib fallback)'}")

    cfg = presets.poisson_saturne(
        width=64, height=36, lanes=4, chunk_steps=16, iterations=4 * 16 * 2,
        warmup=100, seed=7, bin_strategy=BinStrategy.EXACT,
    )
    key = seed_key(cfg)
    lanes, chunk, nchunks = plan_schedule(cfg)
    seeds = np.asarray(jax.random.uniform(key, (lanes, 3), dtype="float32") * 0.1)
    state = render(cfg, key=key)
    count = np.asarray(state.count)
    oc, _, _ = oracle_render(cfg, seeds, steps_per_lane=chunk * nchunks)
    # report agreement on *visited* pixels: on a mostly-empty canvas the
    # all-pixel number mostly measures that zeros equal zeros
    visited = (count > 0) | (oc > 0)
    eq = count == oc
    agree_visited = eq[visited].mean() if visited.any() else 1.0
    print(
        f"oracle agreement (short-horizon exact): {agree_visited:.4%} on "
        f"{int(visited.sum())} visited px ({eq.mean():.4%} incl. empty)"
    )
    if agree_visited < 0.98:
        print("  FAIL: device arithmetic diverges from the oracle")
        ok = False

    bench_cfg = presets.poisson_saturne(iterations=2_000_000, width=192, height=108, seed=0)
    l, k, n = plan_schedule(bench_cfg)
    jax.block_until_ready(render(bench_cfg))  # warm/compile
    prof = RenderProfile(iterations=l * k * n)
    with prof.phase("render"):
        st = jax.block_until_ready(render(bench_cfg))
    with prof.phase("colorize"):
        np.asarray(jax.device_get(colorize(bench_cfg, st)))
    print(f"throughput: {prof.summary()}")
    print("doctor: OK" if ok else "doctor: PROBLEMS FOUND")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
