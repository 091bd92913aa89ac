"""The lax sort-bin strategies against the host references, across tiers,
canvas shapes and section sizes, with and without a pixel-0 flood, under
``jit`` and ``vmap``; plus the platform-free AUTO resolution, the compile
cache placement, the PNG reader and chip_smoke.py's refusal off the GPU."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from strange_attractor_tpu.certify import exact16_reference, pack_zv_numpy
from strange_attractor_tpu.config import BinStrategy, RenderKind
from strange_attractor_tpu.models import presets
from strange_attractor_tpu.ops import binning, kernel_binning as kb
from strange_attractor_tpu.oracle import oracle_bin

ROOT = Path(__file__).resolve().parent.parent
TIERS = ["kernel", "depth-kernel", "exact-kernel", "exact16-value", "exact16-earliest"]
CANVASES = [(1, 1), (200, 3), (1920, 1080)]  # 200: a width that is no multiple of 128


def _stream(npix, n, seed, flood):
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, npix + 1, n).astype(np.int32)  # npix = out of bounds
    z = (np.round(rng.normal(0, 0.5, n) * 16) / 16).astype(np.float32)  # z ties
    z[rng.random(n) < 0.05] = -2.0  # below the sentinel: counted, never wins
    val = rng.random(n).astype(np.float32)
    if flood:
        moved = np.nonzero(rng.random(n) < 0.4)[0]
        flat[moved] = 0
        z[moved[: len(moved) // 2]] = -np.inf
    return flat, z, val


def _blank(tier, npix):
    if tier == "kernel":
        return (jnp.zeros((npix,), jnp.uint32),) * 2
    if tier == "depth-kernel":
        return (jnp.full((npix,), -1.0, jnp.float32),)
    return (jnp.zeros((npix,), jnp.uint32), jnp.zeros((npix,), jnp.float32),
            jnp.full((npix,), -1.0, jnp.float32))


def _bin(tier, planes, flat, z, val, npix, section, flood_gate=True):
    kw = dict(npix=npix, section=section)
    if tier == "kernel":
        return kb.bin_chunk_kernel(*planes, flat, binning.pack_zv(z, val),
                                   flood_gate=flood_gate, **kw)
    if tier == "depth-kernel":
        return kb.bin_chunk_kernel_depth(*planes, flat, z, flood_gate=flood_gate, **kw)
    if tier == "exact-kernel":
        return kb.bin_chunk_kernel_exact(*planes, flat, z, val, **kw)
    ties = tier.split("-")[1]
    return kb.bin_chunk_kernel_exact16(*planes, flat, z, val, ties=ties, **kw)


def _reference(tier, npix, flat, z, val):
    oflat = np.where(flat == npix, -1, flat).astype(np.int64)
    if tier.startswith("exact16"):
        c, s, zb = exact16_reference(npix, [(oflat, z, val)], tier.split("-")[1])
        return [c.astype(np.uint32), s, zb]
    c, s, zb = oracle_bin(npix, 1, oflat, z, val)
    if tier == "depth-kernel":
        return [zb]
    if tier == "exact-kernel":
        return [c.astype(np.uint32), s, zb]
    pk = np.zeros(npix, np.uint32)
    inb = oflat >= 0
    np.maximum.at(pk, oflat[inb], pack_zv_numpy(z, val)[inb])
    return [c.astype(np.uint32), pk]


def _assert_planes(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("section", [1 << 7, 1 << 10])
@pytest.mark.parametrize("canvas", CANVASES, ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("tier", TIERS)
def test_sortbin_matches_reference(tier, canvas, section):
    """jit and vmap, with and without a pixel-0 flood: every plane
    bit-identical to the sequential host reference."""
    npix = canvas[0] * canvas[1]
    n = 1500  # not a multiple of either section: the last one is padded
    streams = [_stream(npix, n, seed, flood) for seed, flood in ((1, False), (2, True))]
    for flat, z, val in streams:
        got = _bin(tier, _blank(tier, npix), *map(jnp.asarray, (flat, z, val)), npix, section)
        _assert_planes(got, _reference(tier, npix, flat, z, val))

    # vmap over two independent canvases, as the batched sequence paths do
    def one(flat, z, val):
        return _bin(tier, _blank(tier, npix), flat, z, val, npix, section, flood_gate=False)

    stacked = [jnp.asarray(np.stack(a)) for a in zip(*streams)]
    got = jax.vmap(one)(*stacked)
    for i, (flat, z, val) in enumerate(streams):
        _assert_planes([g[i] for g in got], _reference(tier, npix, flat, z, val))


def test_pack_zv_numpy_twin():
    rng = np.random.default_rng(5)
    z = rng.normal(0, 2, 4096).astype(np.float32)
    z[:8] = [-1.0, -0.0, 0.0, -np.inf, np.inf, 1e-30, -1e-30, 3.0]
    val = rng.normal(0.5, 0.6, 4096).astype(np.float32)
    np.testing.assert_array_equal(
        pack_zv_numpy(z, val), np.asarray(binning.pack_zv(jnp.asarray(z), jnp.asarray(val))))


@pytest.mark.parametrize("kind", [RenderKind.GAS, RenderKind.DEPTH])
def test_auto_resolves_without_platform(kind):
    """AUTO needs no device: it resolves to EXACT, whose planes serve both
    render kinds."""
    cfg = presets.poisson_saturne(render=kind)
    assert cfg.bin_strategy is BinStrategy.AUTO
    assert cfg.resolved_bin_strategy() is BinStrategy.EXACT


@pytest.mark.parametrize("strategy", [s for s in BinStrategy if s is not BinStrategy.AUTO])
def test_explicit_strategy_resolves_to_itself(strategy):
    cfg = presets.poisson_saturne(bin_strategy=strategy)
    assert cfg.resolved_bin_strategy() is strategy


_CACHE_PROBE = (
    "import jax; from strange_attractor_tpu.utils.profiling import "
    "compilation_cache_dir, enable_compilation_cache; enable_compilation_cache(); "
    "print(compilation_cache_dir()); print(jax.config.jax_compilation_cache_dir)"
)


def _cache_probe(env):
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_compile_cache_honours_env(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "xla"),
               JAX_PLATFORMS="cpu")
    assert _cache_probe(env) == [str(tmp_path / "xla")] * 2


def test_compile_cache_default_is_fixed_and_ignored():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    first, second = _cache_probe(env), _cache_probe(env)
    assert first == second == [str(ROOT / ".jax_cache")] * 2
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT), env=env)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or '"ok": true' not in lines[-1]


def test_chip_smoke_refuses_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [3, 4])
def test_read_png_roundtrip(dtype, channels):
    from strange_attractor_tpu.utils.export import png_bytes, read_png

    rng = np.random.default_rng(channels)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (23, 41, channels)).astype(dtype)
    img[:8] = 0  # flat rows
    img[8:16, :, 0] = (np.arange(41) * 7).astype(dtype)  # gradients
    out = read_png(png_bytes(img))
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("preset", ["poisson_saturne", "solar_sail"])
def test_certify_binning_on_cpu(preset):
    """The on-device certification bench.py and chip_smoke.py run, at a
    small size here."""
    from strange_attractor_tpu.certify import certify_binning, emission_stream

    cfg = getattr(presets, preset)(width=160, height=90, seed=0)
    flat, z, val = emission_stream(cfg, 1 << 13, seed=3)
    assert (flat == 0).mean() > 0.3  # the injected flood
    res = certify_binning(160, 90, flat, z, val, section=1 << 10, log=lambda *_: None)
    assert res["exact_steps_tie_pixels"] >= 0
