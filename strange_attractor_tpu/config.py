"""Render configuration: palette, colors, view, and the main Config.

Mirrors the reference's ``config`` module (src/lib.rs:228-560) as frozen
dataclasses that double as jit-cache keys (via :meth:`Config.fingerprint`).
Numeric defaults match the reference exactly (src/lib.rs:288-308, 397-404,
483-487).
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import Any, Callable, Optional, Sequence

import numpy as np

from .ops.projection import EulerAxisRotation


class RenderKind(enum.Enum):
    """How to render the internal data (reference: src/lib.rs:234-239)."""

    GAS = "gas"
    DEPTH = "depth"


@dataclasses.dataclass(frozen=True)
class View:
    """Camera placement (reference: src/lib.rs:253-261)."""

    center_camera: tuple[float, float, float]
    rotation: EulerAxisRotation
    scale: float = 1.0

    def replace(self, **kw) -> "View":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class BrightnessConstants:
    """Tone-map constants: ``(c + offset) * factor`` (src/lib.rs:389-404).

    The reference misspells this ``BrighnessConstants``; fixed here
    (SURVEY.md quirk list). Defaults: offset -0.15, factor 5/3.
    """

    offset: float = -0.15
    factor: float = 5.0 / 3.0


class Palette:
    """A list of RGB stops interpolated over [0, 1) (src/lib.rs:406-473).

    ``interpolate`` semantics replicated exactly: the input is clamped to
    [0, 0.999999], scaled by the stop count, linearly interpolated between
    neighboring stops, then **square-rooted per channel** (src/lib.rs:442-472).
    The reference appends a duplicate of the last stop so the unchecked
    ``n + 1`` read stays in bounds (src/lib.rs:416-424); we keep the same
    (K+1, 3) layout so gather indices never need clamping.
    """

    def __init__(self, colors: Sequence[Sequence[float]]):
        colors = np.asarray(colors, dtype=np.float64)
        if colors.ndim != 2 or colors.shape[1] != 3 or colors.shape[0] == 0:
            raise ValueError("palette needs a non-empty (K, 3) list of RGB stops")
        self._stops = np.concatenate([colors, colors[-1:]], axis=0)  # (K+1, 3)

    @classmethod
    def from_rgb(cls, r: Sequence[float], g: Sequence[float], b: Sequence[float]) -> "Palette":
        """Construct from per-channel stop lists (src/lib.rs:425-431)."""
        if not (len(r) == len(g) == len(b)):
            raise ValueError("r, g, b must have equal length")
        return cls(np.stack([r, g, b], axis=1))

    @property
    def count(self) -> int:
        """Number of colors (src/lib.rs:435-437)."""
        return self._stops.shape[0] - 1

    @property
    def stops(self) -> np.ndarray:
        """(K+1, 3) float64 stop table, last stop duplicated."""
        return self._stops

    def interpolate_numpy(self, value: np.ndarray) -> np.ndarray:
        """Numpy twin of the device interpolation, for the oracle/tests."""
        value = np.asarray(value, np.float64)
        # only v >= 1.0 clamps (to 0.999999); [0.999999, 1.0) passes through
        # unchanged (src/lib.rs:443-449)
        value = np.where(value >= 1.0, 0.999999, np.maximum(value, 0.0))
        value = value * self.count
        n = np.floor(value).astype(np.int64)
        frac = value % 1.0
        lo = self._stops[n]
        hi = self._stops[n + 1]
        return np.sqrt(hi * frac[..., None] + lo * (1.0 - frac[..., None]))

    def fingerprint(self) -> bytes:
        return b"palette:" + self._stops.tobytes()

    def __eq__(self, other):
        return isinstance(other, Palette) and np.array_equal(self._stops, other._stops)

    def __repr__(self):
        return f"Palette({self._stops[:-1].tolist()!r})"


def default_palette() -> Palette:
    """The reference's default 6-stop palette (src/lib.rs:483-487)."""
    return Palette.from_rgb(
        [1.0, 0.5, 1.0, 0.5, 0.5, 1.0],
        [1.0, 1.0, 0.5, 1.0, 0.5, 0.5],
        [0.5, 0.5, 0.5, 1.0, 1.0, 1.0],
    )


@dataclasses.dataclass(frozen=True)
class Colors:
    """Palette + brightness (reference: src/lib.rs:474-492)."""

    palette: Palette = dataclasses.field(default_factory=default_palette)
    brightness: BrightnessConstants = dataclasses.field(default_factory=BrightnessConstants)


class BinStrategy(enum.Enum):
    """How points are accumulated into the canvas (no reference counterpart).

    - EXACT:  three planes (count u32, steps f32, zbuf f32); z-test winner via
      scatter-max + gather, bit-faithful to the reference semantics
      (src/lib.rs:807-834). The oracle-matching mode.
    - PACKED: two planes (count u32, packed u32). The (zbuf, steps) pair is
      packed into one uint32 — 20 high bits of an order-preserving map of the
      f32 depth, 12 low bits of the quantized palette position — so the whole
      z-test becomes a single scatter-max. Depth resolution ~2^-11 relative,
      palette resolution 1/4096: visually lossless, half the scatter traffic.
    - DEPTH:  one exact f32 z-buffer plane only — all a RenderKind.DEPTH
      output needs — for another 2x less scatter traffic. Such a state
      cannot be colorized as Gas.
    - KERNEL: PACKED-identical output planes, accumulated by the sort-bin
      pipeline (ops/kernel_binning.py): each chunk is sorted by pixel and
      every pixel run updates the planes once. Bit-exact to PACKED: same
      pack_zv packing, same count/max semantics, so states interchange
      freely.
    - EXACT_KERNEL: EXACT-identical full-f32 planes and reference z-test
      semantics through the same sort-bin pipeline, and *stronger* than the
      scatter path on one edge: equal-(pixel, z) duplicates within a chunk
      resolve deterministically to the earliest-emitted value (the
      reference's strict z2 > zbuf).
    - EXACT16_KERNEL: the same EXACT planes and strict z-test discipline
      with z compared at 16-bit mono-bucket granularity (2^-7 relative)
      and values carried as float16 — one 4-byte winner payload instead
      of EXACT_KERNEL's two, and (with the default ``exact16_ties="value"``)
      an unstable 2-operand sort. The middle fidelity tier; precision
      contract and the bucket-tie disciplines in
      ops/kernel_binning.bin_chunk_kernel_exact16.
    - DEPTH_KERNEL: DEPTH-identical single zbuf plane through the sort-bin
      pipeline (the winner key is the monotone-u32 image of z).
    - AUTO:   EXACT, for both render kinds.
    """

    EXACT = "exact"
    PACKED = "packed"
    DEPTH = "depth"
    KERNEL = "kernel"
    EXACT_KERNEL = "exact-kernel"
    EXACT16_KERNEL = "exact16-kernel"
    DEPTH_KERNEL = "depth-kernel"
    AUTO = "auto"

    def planes_kind(self) -> "BinStrategy":
        """The state-plane layout this strategy accumulates into (the
        *_KERNEL strategies share the XLA strategies' planes; they differ
        only in the accumulation path)."""
        if self == BinStrategy.KERNEL:
            return BinStrategy.PACKED
        if self in (BinStrategy.EXACT_KERNEL, BinStrategy.EXACT16_KERNEL):
            return BinStrategy.EXACT
        if self == BinStrategy.DEPTH_KERNEL:
            return BinStrategy.DEPTH
        return self


@dataclasses.dataclass(frozen=True)
class Config:
    """All render parameters (reference: src/lib.rs:263-308).

    Defaults match ``Config::new`` (src/lib.rs:288-308): 10^7 iterations,
    1920x1080, gas render, transparent, angle 0, silent.

    Accelerator tuning knobs (no reference counterpart):

    - ``lanes``: number of independent trajectories advanced in parallel
      (the vmapped batch). ``None`` = auto from ``iterations``. This replaces
      the reference's thread count x jobs-per-thread work splitting
      (src/lib.rs:1058).
    - ``chunk_steps``: scan steps per binning flush; bounds the on-device
      point buffer. An explicitly set value is executed exactly (the chunk
      count rounds up, so the executed iteration total may exceed the
      request by up to one lanes x chunk_steps block); ``None`` = auto,
      where the planner may even chunk lengths to track the request
      (see render.plan_schedule).
    - ``warmup``: discarded iterations to settle onto the attractor
      (reference hardcodes 1000, src/lib.rs:749-752).
    - ``bin_strategy``: see :class:`BinStrategy`.
    - ``dtype``: compute dtype ("float32" default; "float64" needs
      jax_enable_x64 and is slower than float32).
    - ``seed``: RNG seed for the initial points; ``None`` = nondeterministic
      (like the reference's OS-seeded SmallRng, src/lib.rs:656).
    """

    attractor: Any
    view: View
    color_transform: Callable
    iterations: int = 10_000_000
    width: int = 1920
    height: int = 1080
    render: RenderKind = RenderKind.GAS
    transparent: bool = True
    angle: float = 0.0
    silent: bool = True
    colors: Colors = dataclasses.field(default_factory=Colors)

    # accelerator tuning
    lanes: Optional[int] = None
    chunk_steps: Optional[int] = None
    warmup: int = 1000
    bin_strategy: BinStrategy = BinStrategy.AUTO
    # *_KERNEL strategies: points per sorted section (None = the measured
    # per-tier default in ops/kernel_binning.py)
    kernel_section: Optional[int] = None
    # EXACT16_KERNEL bucket-tie discipline: "value" (default — smallest f16
    # bit-pattern of the top z bucket wins; an unstable 2-operand sort) or
    # "earliest" (first-emitted point of the top bucket, EXACT_KERNEL's
    # discipline, via the stable sort).
    # Both are deterministic choices within the documented 2^-7 z-bucket
    # quantization; see ops/kernel_binning.bin_chunk_kernel_exact16.
    exact16_ties: str = "value"
    dtype: str = "float32"
    seed: Optional[int] = None
    # Resurrect lanes whose orbit escaped to infinity (see
    # render._reseed_dead_lanes). Off by default for reference parity: the
    # reference lets escaped work units burn their remaining iterations
    # (~40% of solar-sail seeds escape even in its f64 math).
    reseed_lanes: bool = False

    def __post_init__(self):
        if self.width < 1 or self.height < 1:
            raise ValueError(f"image dimensions must be positive, got {self.width}x{self.height}")
        if self.iterations < 0:
            raise ValueError(f"iterations must be non-negative, got {self.iterations}")
        if self.warmup < 0:
            raise ValueError(f"warmup must be non-negative, got {self.warmup}")
        if self.exact16_ties not in ("value", "earliest"):
            raise ValueError(
                f"exact16_ties must be 'value' or 'earliest', got {self.exact16_ties!r}")
        if self.kernel_section is not None:
            ks = int(self.kernel_section)
            # sections are powers of two (the earliest-ties u64 sort key
            # packs a within-section emission index); below 128 points a
            # section is all per-sort overhead
            if ks < 128 or ks & (ks - 1):
                raise ValueError(
                    f"kernel_section must be a power of two >= 128, got {ks}")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    # ---- derived tuning -------------------------------------------------
    def resolved_lanes(self) -> int:
        """Lane count: keep per-lane trajectories long enough that the
        1000-step warm-up stays amortized (reference granularity argument:
        src/lib.rs:1058 gives ~1e6-1e7 steps per work unit)."""
        if self.lanes is not None:
            return max(1, int(self.lanes))
        # POWER-OF-TWO lanes nearest to iterations/4000, clamped to
        # [512, 32768]. More lanes give the map step more parallel work but
        # pay the 1000-step warm-up on every lane. The rule was tuned on the
        # system's first accelerator and is not yet re-measured on the H100
        # (ROADMAP 1.4).
        target = max(512, min(32_768, self.iterations // 4_000))
        # degenerate micro renders (iterations < the 512-lane floor): don't
        # launch more lanes than iterations — executed = lanes * >=1 steps
        # would over-run the request many-fold (iterations=100 at 512 lanes
        # executes 512). Perf is irrelevant down here; bounded over-run
        # (< 2x, one step per lane) matters for parity-sensitive micro
        # configs (round-4 advisor finding).
        if self.iterations < 512:
            target = 1 << max(0, self.iterations.bit_length() - 1)
            return max(1, target)
        pow2 = 1 << (target.bit_length() - 1)
        if target - pow2 > 2 * pow2 - target:  # round to nearest power of 2
            pow2 <<= 1
        return pow2

    def resolved_chunk_steps(self) -> int:
        if self.chunk_steps is not None:
            return max(1, int(self.chunk_steps))
        lanes = self.resolved_lanes()
        # per-chunk point buffer: 2^22 points for the sort-bin strategies
        # (longer sorted runs per section), 2^20 for the scatter ones. Both
        # are not yet re-measured on the H100 (ROADMAP 1.4). The buffer is
        # filled even at small lane counts; the 16384-step cap bounds the
        # scan length for hand-set tiny lane counts.
        scatter = (BinStrategy.PACKED, BinStrategy.EXACT, BinStrategy.DEPTH)
        buf = 1 << 20 if self.resolved_bin_strategy() in scatter else 1 << 22
        return max(1, min(16_384, buf // lanes))

    def resolved_bin_strategy(self) -> BinStrategy:
        """AUTO resolves to EXACT, whose planes serve both render kinds;
        any other strategy is returned as set. The choice needs no device,
        so Config stays free of the JAX backend."""
        if self.bin_strategy != BinStrategy.AUTO:
            return self.bin_strategy
        return BinStrategy.EXACT

    # ---- jit cache key ---------------------------------------------------
    def fingerprint(self) -> bytes:
        """Stable digest of everything that affects compiled render output."""
        h = hashlib.sha256()
        h.update(self.attractor.fingerprint())
        tf = getattr(self.color_transform, "fingerprint", None)
        h.update(tf() if tf else repr(self.color_transform).encode())
        rot = self.view.rotation
        parts = [
            self.view.center_camera,
            rot.axis,
            rot.rotation,
            rot.normalize,
            self.view.scale,
            self.iterations,
            self.width,
            self.height,
            self.render.value,
            self.transparent,
            self.angle,
            # lanes/chunk_steps enter kernel cache keys as *resolved* values
            self.resolved_lanes(),
            self.resolved_chunk_steps(),
            self.warmup,
            self.bin_strategy.value,
            self.kernel_section,
            self.exact16_ties,
            self.dtype,
            self.reseed_lanes,
        ]
        h.update(repr(parts).encode())
        h.update(self.colors.palette.fingerprint())
        h.update(repr((self.colors.brightness.offset, self.colors.brightness.factor)).encode())
        return h.digest()
