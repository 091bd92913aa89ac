"""RenderState edge cases and checkpoint round-trips per strategy."""

import numpy as np
import pytest

import jax.numpy as jnp

from strange_attractor_tpu.config import BinStrategy
from strange_attractor_tpu import presets, render, merge
from strange_attractor_tpu.runtime import RenderState, load_state, save_state


def test_empty_state_raises():
    with pytest.raises(ValueError, match="empty"):
        RenderState().shape


def test_merge_strategy_mismatch_raises():
    a = RenderState(count=jnp.zeros((2, 2), jnp.uint32), packed=jnp.zeros((2, 2), jnp.uint32))
    b = RenderState(
        count=jnp.zeros((2, 2), jnp.uint32),
        steps=jnp.zeros((2, 2), jnp.float32),
        zbuf=jnp.full((2, 2), -1.0, jnp.float32),
    )
    with pytest.raises(ValueError, match="strategies"):
        merge(a, b)


def test_merge_shape_mismatch_raises():
    a = RenderState(count=jnp.zeros((2, 2), jnp.uint32), packed=jnp.zeros((2, 2), jnp.uint32))
    b = RenderState(count=jnp.zeros((3, 2), jnp.uint32), packed=jnp.zeros((3, 2), jnp.uint32))
    with pytest.raises(ValueError, match="shapes"):
        merge(a, b)


@pytest.mark.parametrize("bad", [64, 100, 96])
def test_kernel_section_validated_up_front(bad):
    with pytest.raises(ValueError, match="kernel_section"):
        presets.poisson_saturne(kernel_section=bad)


def test_auto_config_fingerprint_is_backend_free(monkeypatch):
    """Constructing and fingerprinting a bin_strategy=AUTO Config must not
    touch the JAX backend: AUTO resolves from the config alone. Make any
    default_backend()/devices() call raise to prove it."""
    import jax

    def boom():
        raise AssertionError("Config touched the backend")

    monkeypatch.setattr(jax, "default_backend", boom)
    monkeypatch.setattr(jax, "devices", boom)

    cfg = presets.poisson_saturne(iterations=10**9)
    assert cfg.bin_strategy is BinStrategy.AUTO
    fp = cfg.fingerprint()
    assert isinstance(fp, bytes) and len(fp) == 32
    # AUTO resolves to EXACT, a scatter strategy: the scatter chunk buffer
    assert cfg.resolved_lanes() * cfg.resolved_chunk_steps() <= 1 << 20


@pytest.mark.parametrize("strategy", [BinStrategy.EXACT, BinStrategy.PACKED, BinStrategy.DEPTH])
def test_checkpoint_roundtrip_all_strategies(tmp_path, strategy):
    from strange_attractor_tpu.config import RenderKind

    cfg = presets.poisson_saturne(
        iterations=5000, width=16, height=9, lanes=32, chunk_steps=16, seed=1,
        bin_strategy=strategy,
        render=RenderKind.DEPTH if strategy == BinStrategy.DEPTH else RenderKind.GAS,
    )
    st = render(cfg)
    path = tmp_path / f"{strategy.value}.npz"
    save_state(str(path), st)
    loaded = load_state(str(path))
    assert loaded.strategy == strategy
    for a, b in zip(st, loaded):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("strategy", [BinStrategy.EXACT, BinStrategy.PACKED, BinStrategy.DEPTH])
def test_set_width_height(strategy):
    """Reference Runtime::set_width_height parity (src/lib.rs:666-675):
    matching dims keep the state; a mismatch yields a reset state of the new
    size and the same strategy."""
    from strange_attractor_tpu.config import RenderKind

    cfg = presets.poisson_saturne(
        iterations=5000, width=16, height=9, lanes=32, chunk_steps=16, seed=1,
        bin_strategy=strategy,
        render=RenderKind.DEPTH if strategy == BinStrategy.DEPTH else RenderKind.GAS,
    )
    st = render(cfg)
    assert st.set_width_height(16, 9) is st
    resized = st.set_width_height(32, 18)
    assert resized.shape == (18, 32)
    assert resized.strategy == strategy
    if strategy != BinStrategy.DEPTH:
        assert int(resized.count.sum()) == 0  # reset, like the reference
    # the resized state accumulates under the resized config
    st2 = render(cfg.replace(width=32, height=18), resized)
    planes = [p for p in st2 if p is not None]
    assert all(p.shape == (18, 32) for p in planes)


def test_pinned_chunk_steps_executed_exactly():
    """An explicit Config.chunk_steps is a contract, not a hint: the planner
    must not silently even it to another length (round-4 advisor finding).
    The chunk count rounds up instead."""
    from strange_attractor_tpu.render import plan_schedule

    cfg = presets.poisson_saturne(iterations=10_000, lanes=32, chunk_steps=32)
    lanes, chunk, nchunks = plan_schedule(cfg)
    assert (lanes, chunk) == (32, 32)
    target_steps = round(10_000 / 32)
    assert nchunks == -(-target_steps // 32)
    # executed total overshoots by less than one lanes x chunk_steps block
    executed = lanes * chunk * nchunks
    assert 10_000 <= executed + lanes * chunk
    assert executed < 10_000 + lanes * chunk


def test_auto_chunks_track_request():
    """Auto chunks still even out to track the request closely."""
    from strange_attractor_tpu.render import plan_schedule

    cfg = presets.poisson_saturne(iterations=10**7)
    lanes, chunk, nchunks = plan_schedule(cfg)
    executed = lanes * chunk * nchunks
    assert abs(executed - 10**7) <= lanes * nchunks  # one step round per chunk


def test_micro_render_lane_clamp():
    """iterations < the 512-lane floor must not over-execute many-fold
    (round-4 advisor finding): lanes are clamped to a power of two at or
    below the request, bounding the executed count under 2x."""
    from strange_attractor_tpu.render import plan_schedule

    for iters in (1, 2, 100, 300, 511):
        cfg = presets.poisson_saturne(iterations=iters)
        lanes, chunk, nchunks = plan_schedule(cfg)
        assert lanes <= max(1, iters)
        assert lanes * chunk * nchunks < 2 * iters + lanes
    # at or past the floor, the measured schedule rules stay untouched
    assert presets.poisson_saturne(iterations=512).resolved_lanes() == 512
    assert presets.poisson_saturne(iterations=10**7).resolved_lanes() == 2048
