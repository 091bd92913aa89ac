"""Strange-attractor renderer on JAX.

A JAX/XLA framework with the full capability surface of the reference Rust
renderer (Icelk/strange-attractor-renderer), re-architected for an
accelerator (an NVIDIA H100 today):

- The chaotic map iterates as a fused ``lax.scan`` over a vmapped batch of
  trajectories ("lanes") instead of per-thread loops
  (reference: src/lib.rs:747-838).
- The per-pixel hit-count / depth / color accumulation is a device-side
  binning step (scatter or packed-key strategies) instead of random-access
  writes to a shared canvas (reference: src/lib.rs:807-834).
- Per-worker canvas merging is a device-side reduction / collective
  (reference: src/lib.rs:708-738, 1051-1082).

Pipeline (mirrors the reference's documented pipeline at src/lib.rs:4-29)::

    from strange_attractor_tpu import presets, render, colorize, RenderState

    config = presets.poisson_saturne(iterations=100_000_000)
    state = RenderState.create(config)
    state = render(config, state)        # accumulates; call again to refine
    image = colorize(config, state)      # (H, W, 4) uint16 RGBA

or the one-shot parallel path (reference: src/lib.rs:1051)::

    image = render_parallel(config)
"""

from .config import (
    BinStrategy,
    BrightnessConstants,
    Colors,
    Config,
    Palette,
    RenderKind,
    View,
)
from .models.attractors import Attractor, PolynomialSprott2Degree
from .models.transforms import AdjustedVelocity, poisson_saturne_transform
from .models import presets
from .ops.projection import EulerAxisRotation
from .runtime import RenderState, merge
from .render import (
    colorize,
    colorize_convert_fetch,
    precompile,
    render,
    render_frame,
    render_parallel,
    render_sequence,
    render_sequence_batched,
    render_sequence_shared,
)

__version__ = "0.1.0"

__all__ = [
    "AdjustedVelocity",
    "Attractor",
    "BinStrategy",
    "BrightnessConstants",
    "Colors",
    "Config",
    "EulerAxisRotation",
    "Palette",
    "PolynomialSprott2Degree",
    "RenderKind",
    "RenderState",
    "View",
    "colorize",
    "colorize_convert_fetch",
    "merge",
    "poisson_saturne_transform",
    "precompile",
    "presets",
    "render",
    "render_frame",
    "render_parallel",
    "render_sequence",
    "render_sequence_batched",
    "render_sequence_shared",
]
