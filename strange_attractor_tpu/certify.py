"""Binning certification: every bin strategy on the device against the host
reference.

:func:`emission_stream` draws a realistic point stream — a short real
emission of a preset's map plus a pixel-0 flood like the reference's NaN
quirk (src/lib.rs:789-812) — and :func:`certify_binning` bins it with
every strategy on the default device, in two chunks, and compares the
planes with :func:`oracle.oracle_bin` and numpy references on the host.
``bench.py`` runs it before timing; ``chip_smoke.py`` runs it at full width.
"""

from __future__ import annotations

import time

import numpy as np

from .config import BinStrategy, Config
from .oracle import oracle_bin

_MONO_NEG1 = np.uint32(0x407FFFFF)
_ZKEY_MASK = np.uint32(0xFFFFF000)


def emission_stream(config: Config, n: int, *, seed: int = 0, flood: float = 0.35):
    """``(flat, z, val)`` host arrays of ``n`` points: ``config``'s real
    emission from 4096 warmed lanes (the render's own step function, so
    the support is the attractor's), then a ``flood`` share of points moved
    to pixel 0, half of them with the -inf z an escaped orbit carries.
    ``flat == npix`` marks out-of-bounds points."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from .ops.projection import camera_params
    from .render import _dtype, _seed_warm, _split_xyz, _step_fn

    lanes = 4096
    steps = -(-n // lanes)
    cam = camera_params(config.view, 0.0, config.width, config.height)
    dt = _dtype(config)
    step = _step_fn(config, cam, BinStrategy.EXACT)

    @jax.jit
    def emit(key):
        cur = _split_xyz(_seed_warm(config, lanes, dt, key))
        carry = (*cur, *cur, jnp.zeros((lanes,), jnp.int32),
                 jnp.asarray(1.0, dt), jnp.asarray(0.0, dt))
        _, em = lax.scan(step, carry, None, length=steps)
        return tuple(e.reshape(-1)[:n] for e in em)

    flat, z, val = (np.asarray(a) for a in jax.device_get(emit(jax.random.PRNGKey(seed))))
    flat, z, val = flat.copy(), z.copy(), val.copy()
    rng = np.random.default_rng(seed)
    moved = np.nonzero(rng.random(n) < flood)[0]
    flat[moved] = 0
    z[moved[: len(moved) // 2]] = -np.inf
    return flat.astype(np.int32), z.astype(np.float32), val.astype(np.float32)


def pack_zv_numpy(z, val):
    """Numpy twin of :func:`ops.binning.pack_zv`."""
    z = np.asarray(z, np.float32)
    u = z.view(np.uint32)
    mono = np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    d = (mono - _MONO_NEG1).astype(np.uint32)
    q = np.clip(np.asarray(val, np.float32), np.float32(0.0), np.float32(0.999999))
    with np.errstate(invalid="ignore"):
        q = (q * np.float32(4096.0)).astype(np.uint32)
    return np.where(z > -1.0, (d & _ZKEY_MASK) | q, np.uint32(0)).astype(np.uint32)


def _bucket_edge(k16):
    """Lower edge of a 16-bit mono z bucket (EXACT16's stored depth)."""
    m = (k16.astype(np.uint32) << 16).astype(np.uint32)
    bits = np.where(m < np.uint32(0x80000000), ~m, m & np.uint32(0x7FFFFFFF))
    return bits.astype(np.uint32).view(np.float32)


def exact16_reference(npix, chunks, ties):
    """EXACT16_KERNEL's documented contract as a host reference: per chunk,
    the top 16-bit z bucket wins with ``ties`` picking among bucket ties
    (earliest emission, or smallest f16 bit pattern); chunks merge with the
    strict ``z2 > zbuf`` test on the bucket edge. Returns (count, steps,
    zbuf) over ``chunks`` of oracle-convention ``(flat, z, val)``."""
    count = np.zeros(npix, np.uint64)
    steps = np.zeros(npix, np.float32)
    zbuf = np.full(npix, -1.0, np.float32)
    for flat, z, val in chunks:
        count += np.bincount(flat[flat >= 0], minlength=npix).astype(np.uint64)
        zc = np.where(z == 0.0, np.float32(0.0), z).astype(np.float32)
        u = zc.view(np.uint32)
        mono = np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000)).astype(np.uint32)
        sk = np.where(zc > -1.0, (~(mono >> 16)) & np.uint32(0xFFFF), np.uint32(0xFFFF))
        v16 = val.astype(np.float16)
        idx = np.nonzero((flat >= 0) & (sk != 0xFFFF))[0]
        tie = idx if ties == "earliest" else v16[idx].view(np.uint16)
        order = idx[np.lexsort((idx, tie, sk[idx], flat[idx]))]
        f = flat[order]
        win = order[np.concatenate([[True], f[1:] != f[:-1]])] if len(order) else order
        z_q = _bucket_edge((~sk[win]) & np.uint32(0xFFFF))
        take = z_q > zbuf[flat[win]]
        zbuf[flat[win][take]] = z_q[take]
        steps[flat[win][take]] = v16[win][take].astype(np.float32)
    return count, steps, zbuf


def _tie_pixels(npix, chunks):
    """Pixels where, within one chunk, the winning z is reached by more
    than one point: the only place the EXACT scatter path may pick another
    value than the reference (ops/binning.bin_chunk_exact)."""
    out = np.zeros(npix, bool)
    for flat, z, _ in chunks:
        inb = flat >= 0
        zmax = np.full(npix, -np.inf, np.float32)
        np.maximum.at(zmax, flat[inb], z[inb])
        hit = inb & (z > -1.0)
        hit[inb] &= z[inb] == zmax[flat[inb]]
        out |= np.bincount(flat[hit], minlength=npix) > 1
    return out


def certify_binning(width: int, height: int, flat, z, val, *, section=None,
                    log=print) -> dict:
    """Bin ``(flat, z, val)`` (``flat == npix`` out of bounds) with every
    strategy on the default device, as two chunks, and compare with the
    host references; ``section`` overrides the sort-bin strategies'
    production section sizes. Raises AssertionError on any mismatch; returns
    ``{"exact_steps_tie_pixels": n}``, the pixels where the EXACT scatter
    path's steps plane legitimately differs from the oracle."""
    import jax
    import jax.numpy as jnp

    from .ops import binning, kernel_binning as kb

    npix = width * height
    half = flat.size // 2
    dev_chunks = [tuple(jnp.asarray(a[s]) for a in (flat, z, val))
                  for s in (slice(0, half), slice(half, None))]
    host_chunks = [(np.where(flat[s] == npix, -1, flat[s]).astype(np.int64), z[s], val[s])
                   for s in (slice(0, half), slice(half, None))]

    t0 = time.perf_counter()
    oc = os_ = oz = None
    for hf, hz, hv in host_chunks:
        oc, os_, oz = oracle_bin(width, height, hf, hz, hv, oc, os_, oz)
    oc = oc.astype(np.uint32)
    all_flat = np.concatenate([c[0] for c in host_chunks])
    inb = all_flat >= 0
    ref_pk = np.zeros(npix, np.uint32)
    np.maximum.at(ref_pk, all_flat[inb], pack_zv_numpy(z, val)[inb])
    log(f"  host reference: {time.perf_counter() - t0:.1f}s")

    def run(fn, planes, payload):
        for (f, zz, vv) in dev_chunks:
            planes = fn(planes, f, *payload(zz, vv))
        return [np.asarray(p) for p in jax.device_get(planes)]

    def same(got, want):
        eq = got == want
        if got.dtype.kind == "f":
            eq |= np.isnan(got) & np.isnan(want)
        return eq

    def check(name, got, want):
        eq = same(got, want)
        log(f"  {name}: {'bit-exact' if eq.all() else 'MISMATCH'}")
        if not eq.all():
            bad = np.nonzero(~eq)[0][:5]
            raise AssertionError(f"{name} differs at {bad}: {got[bad]} vs {want[bad]}")

    zeros_u = jnp.zeros((npix,), jnp.uint32)
    blank_exact = (zeros_u, jnp.zeros((npix,), jnp.float32),
                   jnp.full((npix,), -1.0, jnp.float32))
    blank_depth = (jnp.full((npix,), -1.0, jnp.float32),)
    packed_of = lambda zz, vv: (binning.pack_zv(zz, vv),)  # noqa: E731
    kw = dict(npix=npix) if section is None else dict(npix=npix, section=section)

    c, p = run(lambda pl, f, pk: binning.bin_chunk_packed(*pl, f, pk),
               (zeros_u, zeros_u), packed_of)
    check("PACKED count", c, oc)
    check("PACKED packed", p, ref_pk)
    for gate in (True, False):
        kc, kp = run(lambda pl, f, pk: kb.bin_chunk_kernel(*pl, f, pk, flood_gate=gate, **kw),
                     (zeros_u, zeros_u), packed_of)
        check(f"KERNEL (flood_gate={gate}) count == PACKED", kc, c)
        check(f"KERNEL (flood_gate={gate}) packed == PACKED", kp, p)

    (d,) = run(lambda pl, f, zz: binning.bin_chunk_depth(*pl, f, zz),
               blank_depth, lambda zz, vv: (zz,))
    check("DEPTH zbuf", d, oz)
    for gate in (True, False):
        (kd,) = run(lambda pl, f, zz: kb.bin_chunk_kernel_depth(*pl, f, zz, flood_gate=gate, **kw),
                    blank_depth, lambda zz, vv: (zz,))
        check(f"DEPTH_KERNEL (flood_gate={gate}) zbuf == DEPTH", kd, d)

    def exact_payload(zz, vv):
        return zz, vv

    ec, es, ez = run(lambda pl, f, zz, vv: binning.bin_chunk_exact(*pl, f, zz, vv),
                     blank_exact, exact_payload)
    check("EXACT count", ec, oc)
    check("EXACT zbuf", ez, oz)
    differ = ~same(es, os_)
    ties = _tie_pixels(npix, host_chunks)
    n_differ = int(differ.sum())
    log(f"  EXACT steps: {n_differ} px differ from the oracle, "
        f"{int(ties.sum())} px hold within-chunk z ties")
    if (differ & ~ties).any():
        bad = np.nonzero(differ & ~ties)[0][:5]
        raise AssertionError(f"EXACT steps differ off z ties at {bad}")

    kc, ks, kz = run(lambda pl, f, zz, vv: kb.bin_chunk_kernel_exact(*pl, f, zz, vv, **kw),
                     blank_exact, exact_payload)
    check("EXACT_KERNEL count", kc, oc)
    check("EXACT_KERNEL zbuf", kz, oz)
    check("EXACT_KERNEL steps", ks, os_)

    for ties_mode, x64 in (("value", False), ("earliest", False), ("earliest", True)):
        rc, rs, rz = exact16_reference(npix, host_chunks, ties_mode)
        with jax.enable_x64(x64):
            qc, qs, qz = run(
                lambda pl, f, zz, vv: kb.bin_chunk_kernel_exact16(
                    *pl, f, zz, vv, ties=ties_mode, **kw),
                blank_exact, exact_payload)
        tag = f"EXACT16_KERNEL (ties={ties_mode}, x64={x64})"
        check(f"{tag} count", qc, rc.astype(np.uint32))
        check(f"{tag} zbuf", qz, rz)
        check(f"{tag} steps", qs, rs)
    return {"exact_steps_tie_pixels": n_differ}
