"""Attractor map definitions.

The reference defines an ``Attractor`` trait with a single ``next_point``
method (src/lib.rs:71-77) and one concrete map, the second-degree polynomial
Sprott attractor (src/lib.rs:575-621). Here an attractor is any object with a
``step(p) -> p'`` method over ``(..., 3)`` arrays, traced into ``lax.scan`` —
the whole batch of trajectory lanes advances in one vectorized step on the
VPU, replacing the reference's per-thread scalar loop.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Attractor(Protocol):
    """Polymorphic chaotic map (reference trait: src/lib.rs:71-77)."""

    def step(self, p):
        """Advance ``p`` (..., 3) one map iteration; pure & traceable."""
        ...

    def fingerprint(self) -> bytes:
        """Stable bytes identifying this attractor (for jit caching)."""
        ...


@dataclasses.dataclass(frozen=True)
class PolynomialSprott2Degree:
    """Second-degree polynomial Sprott map (reference: src/lib.rs:575-621).

    The next point is three dot products of the 10-element monomial vector
    ``[1, x, x^2, xy, xz, y, y^2, yz, z, z^2]`` (src/lib.rs:602-613) with the
    coefficient rows ``x``, ``y``, ``z`` (src/lib.rs:615-619).

    ``x``/``y``/``z`` are length-10 coefficient tuples. The step is written as
    an explicit fused multiply-add chain in the same term order as the
    reference's ``sum_coefficients`` loop (src/lib.rs:588-600) so it runs as
    pure elementwise VPU work over the lane batch.
    """

    x: tuple[float, ...]
    y: tuple[float, ...]
    z: tuple[float, ...]

    def __post_init__(self):
        for name in ("x", "y", "z"):
            v = getattr(self, name)
            if len(v) != 10:
                raise ValueError(f"coefficient row {name!r} must have 10 entries, got {len(v)}")
            object.__setattr__(self, name, tuple(float(c) for c in v))

    def step(self, p):
        import jax.numpy as jnp

        nx, ny, nz = self.step_xyz(p[..., 0], p[..., 1], p[..., 2])
        return jnp.stack([nx, ny, nz], axis=-1)

    def step_xyz(self, x, y, z):
        """Component form of :meth:`step` — the hot-path variant.

        The render loop keeps x/y/z as separate (lanes,) arrays, so every
        elementwise op runs over contiguous lanes with no 3-wide minor
        dimension, and calls this directly.
        """
        import jax.numpy as jnp

        dt = x.dtype
        one = jnp.ones_like(x)
        monoms = (one, x, x * x, x * y, x * z, y, y * y, y * z, z, z * z)

        def dot(coeffs):
            acc = jnp.asarray(coeffs[0], dt) * monoms[0]
            for c, m in zip(coeffs[1:], monoms[1:]):
                acc = acc + jnp.asarray(c, dt) * m
            return acc

        return dot(self.x), dot(self.y), dot(self.z)

    def step_numpy(self, p: np.ndarray) -> np.ndarray:
        """Numpy twin of :meth:`step` for the CPU oracle."""
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        dt = p.dtype
        monoms = (np.ones_like(x), x, x * x, x * y, x * z, y, y * y, y * z, z, z * z)

        def dot(coeffs):
            acc = dt.type(coeffs[0]) * monoms[0]
            for c, m in zip(coeffs[1:], monoms[1:]):
                acc = acc + dt.type(c) * m
            return acc

        return np.stack([dot(self.x), dot(self.y), dot(self.z)], axis=-1)

    def fingerprint(self) -> bytes:
        return b"sprott2:" + np.asarray(self.x + self.y + self.z, np.float64).tobytes()


class _RK4Ode:
    """Shared fixed-step RK4 over a component-form derivative.

    Subclasses define ``dt`` (a dataclass field) and
    ``_deriv_xyz(x, y, z) -> (dx, dy, dz)`` using plain arithmetic (works
    for both jnp and numpy arrays). Provides the protocol ``step``, the
    hot-path ``step_xyz`` (see PolynomialSprott2Degree.step_xyz for why
    the render loop works on components), and the oracle's ``step_numpy``.
    """

    def _rk4_xyz(self, x, y, z):
        h = x.dtype.type(self.dt)
        k1 = self._deriv_xyz(x, y, z)
        k2 = self._deriv_xyz(x + 0.5 * h * k1[0], y + 0.5 * h * k1[1], z + 0.5 * h * k1[2])
        k3 = self._deriv_xyz(x + 0.5 * h * k2[0], y + 0.5 * h * k2[1], z + 0.5 * h * k2[2])
        k4 = self._deriv_xyz(x + h * k3[0], y + h * k3[1], z + h * k3[2])
        s = h / x.dtype.type(6.0)
        return tuple(
            v + s * (a + 2.0 * b + 2.0 * c + d)
            for v, a, b, c, d in zip((x, y, z), k1, k2, k3, k4)
        )

    def step_xyz(self, x, y, z):
        return self._rk4_xyz(x, y, z)

    def step(self, p):
        import jax.numpy as jnp

        nx, ny, nz = self._rk4_xyz(p[..., 0], p[..., 1], p[..., 2])
        return jnp.stack([nx, ny, nz], axis=-1).astype(p.dtype)

    def step_numpy(self, p: np.ndarray) -> np.ndarray:
        nx, ny, nz = self._rk4_xyz(p[..., 0], p[..., 1], p[..., 2])
        return np.stack([nx, ny, nz], axis=-1).astype(p.dtype)


@dataclasses.dataclass(frozen=True)
class Lorenz(_RK4Ode):
    """Lorenz system integrated with a fixed-step RK4 — a continuous-time
    attractor demonstrating that the :class:`Attractor` protocol is not tied
    to polynomial maps (the reference's trait makes the same point,
    src/lib.rs:562-564: "You can always implement Attractor yourself!").

    One ``step`` = one RK4 step of size ``dt`` of
    dx=sigma(y-x), dy=x(rho-z)-y, dz=xy-beta*z.
    """

    sigma: float = 10.0
    rho: float = 28.0
    beta: float = 8.0 / 3.0
    dt: float = 0.005

    def _deriv_xyz(self, x, y, z):
        dx = self.sigma * (y - x)
        dy = x * (self.rho - z) - y
        dz = x * y - self.beta * z
        return dx, dy, dz

    def fingerprint(self) -> bytes:
        return b"lorenz:" + np.asarray(
            [self.sigma, self.rho, self.beta, self.dt], np.float64
        ).tobytes()


@dataclasses.dataclass(frozen=True)
class Rossler(_RK4Ode):
    """Roessler system (1976): dx=-y-z, dy=x+a*y, dz=b+z*(x-c).

    The classic a=b=0.2, c=5.7 parameters produce the single-scroll funnel
    band. Continuous-time, like :class:`Lorenz`; not in the reference.
    """

    a: float = 0.2
    b: float = 0.2
    c: float = 5.7
    dt: float = 0.02

    def _deriv_xyz(self, x, y, z):
        dx = -y - z
        dy = x + self.a * y
        dz = self.b + z * (x - self.c)
        return dx, dy, dz

    def fingerprint(self) -> bytes:
        return b"rossler:" + np.asarray(
            [self.a, self.b, self.c, self.dt], np.float64
        ).tobytes()


def _sin(v):
    """``sin`` that works for both numpy arrays (oracle) and jax tracers.

    ``np.sin`` on a jax tracer raises ``TracerArrayConversionError``, so the
    shared RK4 derivative dispatches on the operand type instead.
    """
    if isinstance(v, (np.ndarray, np.generic)):
        return np.sin(v)
    import jax.numpy as jnp

    return jnp.sin(v)


@dataclasses.dataclass(frozen=True)
class Thomas(_RK4Ode):
    """Thomas' cyclically symmetric attractor (Thomas 1999):
    dx=sin(y)-b*x (and cyclic permutations); b=0.208186 is the classic
    chaotic set. The only transcendental map in the family — it exercises
    non-polynomial derivatives through the shared RK4 path (the reference's
    open-trait extension point, src/lib.rs:562-564).
    """

    b: float = 0.208186
    dt: float = 0.1

    def _deriv_xyz(self, x, y, z):
        dx = _sin(y) - self.b * x
        dy = _sin(z) - self.b * y
        dz = _sin(x) - self.b * z
        return dx, dy, dz

    def fingerprint(self) -> bytes:
        return b"thomas:" + np.asarray([self.b, self.dt], np.float64).tobytes()


@dataclasses.dataclass(frozen=True)
class Halvorsen(_RK4Ode):
    """Halvorsen's cyclically symmetric attractor:
    dx=-a*x-4y-4z-y^2 (and cyclic permutations). a=1.4 is the classic set.
    """

    a: float = 1.4
    dt: float = 0.005

    def _deriv_xyz(self, x, y, z):
        dx = -self.a * x - 4.0 * y - 4.0 * z - y * y
        dy = -self.a * y - 4.0 * z - 4.0 * x - z * z
        dz = -self.a * z - 4.0 * x - 4.0 * y - x * x
        return dx, dy, dz

    def fingerprint(self) -> bytes:
        return b"halvorsen:" + np.asarray([self.a, self.dt], np.float64).tobytes()


def as_xyz_step(attractor):
    """(x, y, z) -> (x, y, z) step function for the hot path.

    Uses the attractor's native ``step_xyz`` when it defines one; otherwise
    adapts the protocol ``step`` by stacking (custom attractors keep working
    at the cost of the padded (lanes, 3) layout).
    """
    native = getattr(attractor, "step_xyz", None)
    if native is not None:
        return native

    def adapted(x, y, z):
        import jax.numpy as jnp

        p = attractor.step(jnp.stack([x, y, z], axis=-1))
        return p[..., 0], p[..., 1], p[..., 2]

    return adapted
