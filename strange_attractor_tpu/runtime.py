"""Accumulator state: the device-side equivalent of the reference's ``Runtime``.

The reference keeps three mutable textures plus a running max
(src/lib.rs:631-646): ``count`` (u32 visits), ``steps`` (f64 color value at
the nearest-z visit) and ``zbuf`` (f32 depth, -1.0 sentinel). Here the same
information lives in an immutable pytree of device arrays, which makes

- progressive refinement: feed the state back into ``render`` and it keeps
  accumulating (reference: src/lib.rs:742-744),
- merging: a pure reduction (reference: src/lib.rs:708-738),
- checkpoint/resume: just save/load the pytree (the reference has no disk
  checkpointing; its in-memory accumulation is the analog — SURVEY.md §5).

Two storage strategies (see :class:`~strange_attractor_tpu.config.BinStrategy`):
EXACT keeps (count, steps, zbuf) planes; PACKED fuses (zbuf, steps) into one
uint32 plane so the z-test is a single scatter-max.

The running ``max`` is not stored: ``count.max()`` is one reduction at
colorize time with an identical result (SURVEY.md §7 hard-parts #4).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .config import BinStrategy, Config


class RenderState(NamedTuple):
    """Accumulated render data for one canvas.

    EXACT states carry ``count``+``steps``+``zbuf``; PACKED states carry
    ``count``+``packed``; DEPTH states carry only ``zbuf``. All planes (H, W).
    """

    count: Optional["jax.Array"] = None  # uint32
    steps: Optional["jax.Array"] = None  # float32 (EXACT)
    zbuf: Optional["jax.Array"] = None  # float32, -1.0 sentinel (EXACT/DEPTH)
    packed: Optional["jax.Array"] = None  # uint32 (PACKED)

    @property
    def strategy(self) -> BinStrategy:
        if self.packed is not None:
            return BinStrategy.PACKED
        if self.count is None:
            return BinStrategy.DEPTH
        return BinStrategy.EXACT

    @property
    def shape(self) -> tuple:
        for plane in self:
            if plane is not None:
                return plane.shape
        raise ValueError("empty RenderState")

    @classmethod
    def blank(cls, shape: tuple, strategy: BinStrategy) -> "RenderState":
        """Zeroed planes of a given (H, W) shape and strategy."""
        import jax.numpy as jnp

        strategy = strategy.planes_kind()  # KERNEL states store PACKED planes
        if strategy == BinStrategy.DEPTH:
            return cls(zbuf=jnp.full(shape, -1.0, jnp.float32))
        count = jnp.zeros(shape, jnp.uint32)
        if strategy == BinStrategy.PACKED:
            return cls(count=count, packed=jnp.zeros(shape, jnp.uint32))
        return cls(
            count=count,
            steps=jnp.zeros(shape, jnp.float32),
            zbuf=jnp.full(shape, -1.0, jnp.float32),
        )

    @classmethod
    def create(cls, config: Config, strategy: Optional[BinStrategy] = None) -> "RenderState":
        """Fresh zeroed state (reference ``Runtime::new`` + ``reset``,
        src/lib.rs:660-699: count 0, steps 0.0, zbuf -1.0)."""
        if strategy is None or strategy == BinStrategy.AUTO:
            strategy = config.resolved_bin_strategy()
        return cls.blank((config.height, config.width), strategy)

    def set_width_height(self, width: int, height: int) -> "RenderState":
        """Fit this state to a new canvas size (reference
        ``Runtime::set_width_height``, src/lib.rs:666-675): if the dimensions
        already match, the state is returned unchanged (accumulation
        continues); otherwise a fresh reset state of the new size and the
        same strategy is returned — the reference likewise reallocates and
        resets on mismatch, so accumulated data never survives a resize."""
        if self.shape == (height, width):
            return self
        return RenderState.blank((height, width), self.strategy)

    def reset(self) -> "RenderState":
        """Zeroed state with the same shape/strategy (src/lib.rs:682-699)."""
        import jax.numpy as jnp

        return RenderState(
            count=None if self.count is None else jnp.zeros_like(self.count),
            steps=None if self.steps is None else jnp.zeros_like(self.steps),
            zbuf=None if self.zbuf is None else jnp.full_like(self.zbuf, -1.0),
            packed=None if self.packed is None else jnp.zeros_like(self.packed),
        )


def merge(a: RenderState, b: RenderState) -> RenderState:
    """Combine two renders of the same scene (reference ``Runtime::merge``,
    src/lib.rs:708-738): counts add; where ``b`` is nearer (greater z), its
    steps/zbuf win. Associative + commutative up to equal-z ties, which is
    how the whole parallel scheme is justified (src/lib.rs:1037-1048)."""
    import jax.numpy as jnp

    if a.strategy != b.strategy:
        raise ValueError("cannot merge states with different bin strategies")
    if a.shape != b.shape:
        raise ValueError(f"state shapes differ: {a.shape} vs {b.shape}")
    if a.strategy == BinStrategy.DEPTH:
        return RenderState(zbuf=jnp.maximum(a.zbuf, b.zbuf))
    count = a.count + b.count
    if a.packed is not None:
        return RenderState(count=count, packed=jnp.maximum(a.packed, b.packed))
    take_b = b.zbuf > a.zbuf
    return RenderState(
        count=count,
        steps=jnp.where(take_b, b.steps, a.steps),
        zbuf=jnp.where(take_b, b.zbuf, a.zbuf),
    )


def merge_all(states) -> RenderState:
    """Fold :func:`merge` over a sequence of states (src/lib.rs:1068-1076)."""
    states = list(states)
    if not states:
        raise ValueError("no states to merge")
    acc = states[0]
    for s in states[1:]:
        acc = merge(acc, s)
    return acc


def save_state(path: str, state: RenderState) -> None:
    """Checkpoint a render state to ``.npz`` (progressive-resume support)."""
    import jax

    arrays = {k: np.asarray(jax.device_get(v)) for k, v in state._asdict().items() if v is not None}
    np.savez_compressed(path, **arrays)


def load_state(path: str) -> RenderState:
    """Load a checkpointed render state."""
    import jax.numpy as jnp

    with np.load(path) as data:
        kw = {k: jnp.asarray(data[k]) for k in data.files}
    return RenderState(**kw)
