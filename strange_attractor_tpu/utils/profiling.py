"""Profiling & observability helpers.

The reference's observability story is a handful of ``println!`` calls gated
by ``Config::silent`` (SURVEY.md §5). Here, in addition to those prints, a
render can be wrapped in :class:`RenderProfile` for phase timings and an
iterations/sec figure; the CLI's ``--profile DIR`` captures a
``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class RenderProfile:
    """Collects phase wall-times and derived rates for one render.

    Usage::

        prof = RenderProfile(iterations=executed)
        with prof.phase("render"):
            state = render(config, ...)
            sync(state)
        with prof.phase("colorize"):
            image = fetch(colorize(config, state))
        print(prof.summary())
    """

    iterations: int = 0
    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    @property
    def total_seconds(self) -> float:
        return sum(self.phases.values())

    @property
    def iters_per_sec(self) -> Optional[float]:
        t = self.phases.get("render", self.total_seconds)
        if not self.iterations or t <= 0:
            return None
        return self.iterations / t

    def summary(self) -> str:
        parts = [f"{k}={v:.3f}s" for k, v in self.phases.items()]
        rate = self.iters_per_sec
        if rate is not None:
            parts.append(f"rate={rate:.3e} iters/s")
        return " ".join(parts)


def compilation_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise one fixed
    directory inside the checkout (``.jax_cache``, gitignored). The path is
    part of the cache's key, so it never depends on a temporary name, a PID
    or the time."""
    import os

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, ".jax_cache")


def enable_compilation_cache() -> None:
    """Point JAX at the persistent on-disk compilation cache
    (:func:`compilation_cache_dir`), so a second cold process start skips
    the compiles. Called by the CLI, bench.py and doctor; safe to call
    repeatedly. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
    itself and no other directory is set here."""
    import os

    import jax

    path = compilation_cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except OSError:  # pragma: no cover - read-only checkouts
        pass
