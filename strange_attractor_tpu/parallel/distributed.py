"""Multi-host (multi-process) rendering.

The reference is strictly single-process (its "distributed backend" is std
threads + channels, src/lib.rs:906-1031 — SURVEY.md §5). Scale-out here
has two tiers:

- **single host, many devices**: ``parallel.mesh.render_sharded`` over the
  local devices (collective canvas merge). Nothing here needed.
- **many processes (GPU hosts / CPU test rigs)**: every process runs the
  same program under ``jax.distributed``; the lanes mesh spans the *global*
  device list, ``shard_map`` + the same ``psum``/``pmax`` merge run the
  cross-process legs, and every process ends up holding a replicated
  copy of the merged canvas (fetch/export on the primary only).

Usage (same script launched once per host/process)::

    from strange_attractor_tpu.parallel import distributed as dist

    dist.initialize(coord, nproc, pid)  # or auto under SLURM / MPI
    state = dist.render_distributed(config)
    if dist.is_primary():
        image = colorize(config, state)

Verified by ``tests/test_distributed.py``, which launches two real
processes over a 4-CPU-device gloo mesh and checks the merged canvas is
statistically equivalent to a single-process render of the same budget —
the reference's own merge-of-independent-renders argument
(src/lib.rs:1037-1048).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Bring up the JAX distributed runtime (idempotent).

    Under a cluster manager JAX knows (SLURM, Open MPI) all arguments
    auto-detect from the environment; elsewhere pass them explicitly. For
    CPU meshes the gloo collectives backend
    is selected when available (required for cross-process psum/pmax).
    """
    if getattr(initialize, "_done", False):
        return
    # NOTE: nothing here may touch the XLA backend (jax.devices,
    # jax.default_backend, ...) before jax.distributed.initialize.
    try:  # cross-process CPU collectives need gloo (no effect on GPUs)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:  # pragma: no cover - older jax
        pass
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        if local_device_ids is not None:
            kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)
    initialize._done = True


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


def is_primary() -> bool:
    """True on the process that should write output files."""
    return jax.process_index() == 0


def render_distributed(config, key=None):
    """Render ``config`` with lanes sharded over every device of every
    process. Must be called by ALL processes (it is a collective program).

    Returns the merged :class:`~strange_attractor_tpu.runtime.RenderState`,
    replicated — each process holds an addressable copy, so ``colorize`` /
    export work locally; write files only :func:`is_primary`.
    """
    from .mesh import render_sharded

    return render_sharded(config, jax.devices(), key=key)
