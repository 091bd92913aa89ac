"""Multi-device tests on the 8-way virtual CPU mesh: collective merge
semantics and sharded rendering."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from strange_attractor_tpu import colorize, presets, render
from strange_attractor_tpu.config import BinStrategy, RenderKind
from strange_attractor_tpu.oracle import oracle_bin
from strange_attractor_tpu.parallel.mesh import (
    merge_collective,
    render_sequence_sharded,
    render_sharded,
    shard_map,
)


def test_merge_collective_matches_sequential(cpu_devices):
    """psum/pmax-based merge == the oracle's sequential fold over devices."""
    W, H = 6, 4
    NPIX = W * H
    D = 8
    rng = np.random.default_rng(0)
    counts, steps, zbufs = [], [], []
    streams = []
    for _ in range(D):
        flat = rng.integers(0, NPIX, 200).astype(np.int64)
        z = rng.normal(0, 0.5, 200).astype(np.float32)
        v = rng.random(200).astype(np.float32)
        streams.append((flat, z, v))
        c, s, zb = oracle_bin(W, H, flat, z, v)
        counts.append(c.astype(np.uint32))
        steps.append(s)
        zbufs.append(zb)

    mesh = Mesh(np.array(cpu_devices), ("lanes",))
    fn = jax.jit(
        shard_map(
            lambda c, s, z: merge_collective((c, s, z), BinStrategy.EXACT, "lanes"),
            mesh=mesh,
            in_specs=(P("lanes"), P("lanes"), P("lanes")),
            out_specs=P(),
            check_vma=False,
        )
    )
    got_c, got_s, got_z = fn(
        jnp.asarray(np.stack(counts)), jnp.asarray(np.stack(steps)), jnp.asarray(np.stack(zbufs))
    )
    # sequential oracle: one long stream
    flat = np.concatenate([s[0] for s in streams])
    z = np.concatenate([s[1] for s in streams])
    v = np.concatenate([s[2] for s in streams])
    want_c, want_s, want_z = oracle_bin(W, H, flat, z, v)
    np.testing.assert_array_equal(np.asarray(got_c)[0], want_c)
    np.testing.assert_array_equal(np.asarray(got_z)[0], want_z)
    np.testing.assert_array_equal(np.asarray(got_s)[0], want_s)


def test_merge_collective_packed(cpu_devices):
    D = 8
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 9, (D, 24)).astype(np.uint32)
    packed = rng.integers(0, 2**31, (D, 24)).astype(np.uint32)
    mesh = Mesh(np.array(cpu_devices), ("lanes",))
    fn = jax.jit(
        shard_map(
            lambda c, p: merge_collective((c, p), BinStrategy.PACKED, "lanes"),
            mesh=mesh,
            in_specs=(P("lanes"), P("lanes")),
            out_specs=P(),
            check_vma=False,
        )
    )
    got_c, got_p = fn(jnp.asarray(counts), jnp.asarray(packed))
    np.testing.assert_array_equal(np.asarray(got_c)[0], counts.sum(0))
    np.testing.assert_array_equal(np.asarray(got_p)[0], packed.max(0))


@pytest.mark.parametrize(
    "strategy", [BinStrategy.EXACT, BinStrategy.PACKED, BinStrategy.KERNEL,
                 BinStrategy.EXACT_KERNEL, BinStrategy.EXACT16_KERNEL,
                 BinStrategy.DEPTH_KERNEL]
)
def test_render_sharded(cpu_devices, strategy):
    depth = strategy is BinStrategy.DEPTH_KERNEL
    cfg = presets.poisson_saturne(
        width=64, height=36, iterations=100_000, lanes=256, chunk_steps=64,
        seed=4, bin_strategy=strategy,
        render=RenderKind.DEPTH if depth else RenderKind.GAS,
    )
    st = render_sharded(cfg, cpu_devices)
    # DEPTH states carry only the zbuf plane; visited pixels leave the -1
    # sentinel (src/lib.rs:693)
    cov = (lambda s: np.asarray(s.zbuf) != -1.0) if depth else (
        lambda s: np.asarray(s.count) > 0
    )
    assert cov(st).sum() > 0
    img = np.asarray(jax.device_get(colorize(cfg, st)))
    assert img.shape == (36, 64, 4) and img[..., :3].max() > 0

    # statistically consistent with a single-device render of the same budget
    st1 = render(cfg)
    if not depth:
        c_sh = np.asarray(st.count).astype(np.float64)
        c_1 = np.asarray(st1.count).astype(np.float64)
        assert abs(c_sh.sum() - c_1.sum()) / max(c_1.sum(), 1) < 0.05
    va, vb = cov(st), cov(st1)
    assert (va & vb).sum() / max(1, (va | vb).sum()) > 0.6


def test_banded_delivery_on_sharded_state(cpu_devices):
    """colorize_convert_fetch (the banded overlapped delivery) must accept a
    render_sharded state: the per-band dynamic slices and the stats program
    run on the replicated canvas without resharding errors, byte-identical
    to the plain colorize + host-convert path."""
    from strange_attractor_tpu.render import colorize_convert_fetch
    from strange_attractor_tpu.utils.export import convert_format

    cfg = presets.poisson_saturne(
        width=64, height=36, iterations=100_000, lanes=256, chunk_steps=64,
        seed=4, bin_strategy=BinStrategy.KERNEL,
    )
    st = render_sharded(cfg, cpu_devices)
    expected = convert_format(
        np.asarray(jax.device_get(colorize(cfg, st))), False, True
    )
    got = colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, bands=4)
    np.testing.assert_array_equal(got, expected)
    # second call rides the lit-bbox CROP learned from the first call's
    # rider (render.colorize_convert_fetch crop path) — the cropped band
    # slices must also run on the sharded canvas, byte-identical
    got = colorize_convert_fetch(cfg, st, transparent=False, eight_bit=True, bands=4)
    np.testing.assert_array_equal(got, expected)


def test_render_sequence_sharded(cpu_devices):
    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=30_000, lanes=128, chunk_steps=32, seed=6,
    )
    angles = [0.0, 90.0, 180.0]
    frames = render_sequence_sharded(cfg, angles, cpu_devices)
    assert frames.shape == (3, 27, 48, 4)
    assert frames.dtype == np.uint16
    # different angles produce different images
    assert not np.array_equal(frames[0], frames[1])


def test_render_sequence_sharded_depth_wire(cpu_devices):
    """DEPTH frames on the mesh sequence path wire one gray channel
    (render._wire_channels); the delivered frames must equal the host
    conversion of the raw u16 RGBA mesh frames."""
    from strange_attractor_tpu.utils.export import convert_format

    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=30_000, lanes=128, chunk_steps=32,
        seed=6, render=RenderKind.DEPTH, bin_strategy=BinStrategy.DEPTH_KERNEL,
    )
    angles = [0.0, 90.0, 180.0]
    raw = render_sequence_sharded(cfg, angles, cpu_devices)
    assert raw.shape == (3, 27, 48, 4) and raw.dtype == np.uint16
    for transparent, eight_bit in ((False, True), (True, False)):
        conv = render_sequence_sharded(
            cfg, angles, cpu_devices, transparent=transparent, eight_bit=eight_bit)
        for f_raw, f_conv in zip(raw, conv):
            np.testing.assert_array_equal(
                f_conv, convert_format(f_raw, transparent, eight_bit))


def test_render_sequence_sharded_fresh_seeds_per_frame(cpu_devices):
    """Frames sharing a device row must still render distinct trajectories
    (per-local-frame key fold — round-1 advisor finding): identical angles
    give statistically-equal but not bitwise-equal canvases."""
    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=30_000, lanes=128, chunk_steps=32, seed=6,
    )
    frames = render_sequence_sharded(cfg, [0.0, 0.0, 0.0, 0.0], cpu_devices, frame_axis=2)
    assert frames.shape[0] == 4
    # same row (local frames 0 and 1) and different rows: all distinct seeds
    assert not np.array_equal(frames[0], frames[1])
    assert not np.array_equal(frames[0], frames[2])
    # but the same scene: strong support overlap
    lit = [(f[..., :3].sum(-1) > 0) for f in frames]
    iou = (lit[0] & lit[1]).sum() / max(1, (lit[0] | lit[1]).sum())
    assert iou > 0.5, iou


def test_render_sequence_sharded_frames_per_batch(cpu_devices):
    """frames_per_batch bounds frames per device per program on the mesh
    path (round-3 advisor finding: the sharded route silently dropped the
    user's --frames-per-batch memory bound). Grouped and ungrouped runs
    must agree in shape/dtype and render distinct frames per group."""
    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=30_000, lanes=128, chunk_steps=32, seed=6,
    )
    angles = [0.0, 45.0, 90.0, 135.0, 180.0]
    frames = render_sequence_sharded(
        cfg, angles, cpu_devices, frame_axis=2, frames_per_batch=1
    )
    # 2-frame groups (frame_axis=2 x 1/device): 3 groups incl. a padded tail
    assert frames.shape == (5, 27, 48, 4) and frames.dtype == np.uint16
    for a, b in zip(frames, frames[1:]):
        assert not np.array_equal(a, b)
    # identical angles across group boundaries still get distinct seeds
    dup = render_sequence_sharded(
        cfg, [0.0, 0.0, 0.0], cpu_devices, frame_axis=2, frames_per_batch=1
    )
    assert not np.array_equal(dup[0], dup[2])
    lit = [(f[..., :3].sum(-1) > 0) for f in dup]
    iou = (lit[0] & lit[2]).sum() / max(1, (lit[0] | lit[2]).sum())
    assert iou > 0.5, iou


def test_render_sequence_batched_single_device():
    """Frame axis as a vmapped batch on one device (BASELINE configs[4])."""
    from strange_attractor_tpu.render import render_sequence_batched

    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=30_000, lanes=64, chunk_steps=32, seed=8,
    )
    frames = render_sequence_batched(cfg, [0.0, 90.0, 180.0, 270.0], frames_per_batch=3)
    assert frames.shape == (4, 27, 48, 4) and frames.dtype == np.uint16
    assert not np.array_equal(frames[0], frames[1])
    # batching is just vectorization: same angle in different batch positions
    # gives the same image for the same per-frame key stream
    f2 = render_sequence_batched(cfg, [0.0, 90.0], frames_per_batch=2)
    np.testing.assert_array_equal(f2[0], frames[0])


def test_sequence_device_conversion_matches_host():
    """Device-side deliverable conversion (transparent/eight_bit kwargs) is
    bit-identical to fetching u16 RGBA and converting on host — the sequence
    fetch optimization must not change any written byte."""
    from strange_attractor_tpu.render import render_sequence_batched
    from strange_attractor_tpu.utils.export import convert_format

    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=20_000, lanes=64, chunk_steps=32, seed=8,
    )
    angles = [0.0, 120.0]
    raw = render_sequence_batched(cfg, angles)
    assert raw.dtype == np.uint16 and raw.shape[-1] == 4
    for transparent, eight_bit in ((False, True), (True, True), (False, False)):
        conv = render_sequence_batched(
            cfg, angles, transparent=transparent, eight_bit=eight_bit
        )
        for f_raw, f_conv in zip(raw, conv):
            np.testing.assert_array_equal(
                f_conv, convert_format(f_raw, transparent, eight_bit)
            )


def test_sequence_sharded_shared_orbit_bit_matches_render_sharded(cpu_devices):
    """orbit='shared' on the mesh: every frame must be bit-identical to a
    render_sharded() of its frames-row's orbit key over one row of devices
    at that frame's angle — the mesh form of the single-device shared-orbit
    invariant (tests/test_sequence_shared.py). Collective values are
    device-placement-independent, so any lane_axis-sized device subset
    reproduces a row."""
    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=30_000, lanes=128, chunk_steps=32, seed=6,
    )
    angles = [0.0, 90.0, 180.0, 222.5]
    # 2 frame rows x 4 lane columns: rows render angle pairs from ONE orbit
    frames = render_sequence_sharded(cfg, angles, cpu_devices, frame_axis=2,
                                     orbit="shared")
    assert frames.shape == (4, 27, 48, 4) and frames.dtype == np.uint16
    from strange_attractor_tpu.render import seed_key

    base = seed_key(cfg)
    for i, a in enumerate(angles):
        row = i // 2  # group_len=4, frame_axis=2 -> 2 local frames per row
        st = render_sharded(
            cfg.replace(angle=float(np.radians(a))),
            devices=cpu_devices[:4],
            key=jax.random.fold_in(base, row),
        )
        want = np.asarray(jax.device_get(colorize(cfg, st)))
        np.testing.assert_array_equal(frames[i], want)


def test_sequence_sharded_shared_orbit_within_row(cpu_devices):
    """Equal angles in one frames-row share the orbit (bitwise-equal frames,
    unlike the per-frame path's fresh seeds); rows draw distinct orbits."""
    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=30_000, lanes=128, chunk_steps=32, seed=6,
    )
    frames = render_sequence_sharded(cfg, [45.0, 45.0], cpu_devices,
                                     frame_axis=1, orbit="shared")
    np.testing.assert_array_equal(frames[0], frames[1])
    rows = render_sequence_sharded(cfg, [45.0, 45.0], cpu_devices,
                                   frame_axis=2, orbit="shared")
    assert not np.array_equal(rows[0], rows[1])


def test_sequence_sharded_shared_orbit_grouped(cpu_devices):
    """frames_per_batch grouping on the shared path: each group folds its
    index into the key (gkey = fold_in(base, gi)), so a tail group's frames
    still pin to render_sharded of THAT group's row-0 orbit key."""
    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=30_000, lanes=128, chunk_steps=32, seed=6,
    )
    angles = [0.0, 90.0, 180.0]
    # frame_axis=2, frames_per_batch=1 -> groups [0,90] and [180]
    frames = render_sequence_sharded(cfg, angles, cpu_devices, frame_axis=2,
                                     frames_per_batch=1, orbit="shared")
    assert frames.shape[0] == 3
    from strange_attractor_tpu.render import seed_key

    base = seed_key(cfg)
    # group 1, local row 0, angle 180
    gkey = jax.random.fold_in(base, 1)
    st = render_sharded(
        cfg.replace(angle=float(np.radians(180.0))),
        devices=cpu_devices[:4],
        key=jax.random.fold_in(gkey, 0),
    )
    want = np.asarray(jax.device_get(colorize(cfg, st)))
    np.testing.assert_array_equal(frames[2], want)


def test_sequence_sharded_rejects_unknown_orbit(cpu_devices):
    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=1000, lanes=128, chunk_steps=8, seed=6,
    )
    with pytest.raises(ValueError, match="orbit"):
        render_sequence_sharded(cfg, [0.0], cpu_devices, orbit="typo")


def test_sequence_sharded_device_conversion(cpu_devices):
    """The sharded frames x lanes path honors the same conversion kwargs."""
    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=20_000, lanes=128, chunk_steps=32, seed=6,
    )
    angles = [0.0, 90.0, 180.0]
    raw = render_sequence_sharded(cfg, angles, cpu_devices)
    conv = render_sequence_sharded(cfg, angles, cpu_devices,
                                   transparent=False, eight_bit=True)
    assert conv.shape == (3, 27, 48, 3) and conv.dtype == np.uint8
    from strange_attractor_tpu.utils.export import convert_format

    for f_raw, f_conv in zip(raw, conv):
        np.testing.assert_array_equal(f_conv, convert_format(f_raw, False, True))


def test_render_parallel_single_device_path():
    """render_parallel with one device equals render_frame (reference parity
    entry point, src/lib.rs:1051); jobs_per_thread is accepted and ignored."""
    import jax
    from strange_attractor_tpu.render import render_frame, render_parallel

    cfg = presets.poisson_saturne(iterations=5000, width=24, height=16,
                                  lanes=32, chunk_steps=16, seed=3)
    one_dev = [jax.devices()[0]]
    img_p = render_parallel(cfg, key=jax.random.PRNGKey(1), devices=one_dev,
                            jobs_per_thread=16)
    img_f = render_frame(cfg, key=jax.random.PRNGKey(1))
    np.testing.assert_array_equal(img_p, img_f)


def test_auto_frames_per_batch_uses_planes_kind():
    """EXACT_KERNEL carries EXACT's 12 B/px planes: its auto batch size must
    match EXACT's and stay below PACKED/KERNEL's (round-2 verdict: the raw-
    strategy key overshot fidelity-mode batches ~1.25x toward OOM). The
    estimate also bounds the vmapped per-chunk working set: a small canvas
    must not batch thousands of frames of 4M-point chunk buffers."""
    from strange_attractor_tpu.render import _auto_frames_per_batch, plan_schedule

    cfg = presets.poisson_saturne(width=1920, height=1080)
    lanes, chunk_steps, _ = plan_schedule(cfg)
    sizes = {
        s: _auto_frames_per_batch(cfg, s, lanes, chunk_steps)
        for s in (BinStrategy.EXACT, BinStrategy.EXACT_KERNEL, BinStrategy.KERNEL,
                  BinStrategy.PACKED, BinStrategy.DEPTH, BinStrategy.DEPTH_KERNEL)
    }
    assert sizes[BinStrategy.EXACT_KERNEL] == sizes[BinStrategy.EXACT]
    assert sizes[BinStrategy.KERNEL] == sizes[BinStrategy.PACKED]
    assert sizes[BinStrategy.DEPTH_KERNEL] == sizes[BinStrategy.DEPTH]
    assert sizes[BinStrategy.EXACT_KERNEL] < sizes[BinStrategy.KERNEL]
    # fidelity modes: min(2 GB / (npix*20 B) = 48 canvas-bound, the
    # schedule-dependent work bound — 39 at the sort-bin 4M-point chunks,
    # 48 at the scatter 1M chunks)
    want = min(48, int(6e9 / (lanes * chunk_steps * 12 * 3)))
    assert sizes[BinStrategy.EXACT_KERNEL] == want

    # the working-set bound must bite on small canvases: 256x256 with the
    # 4M-point chunk schedule (16384 lanes x 256 steps) used to estimate
    # ~1900 frames (>60 GB of chunk buffers)
    small = presets.poisson_saturne(width=256, height=256)
    assert _auto_frames_per_batch(small, BinStrategy.KERNEL, 16384, 256) <= 64


def test_sharded_lane_truncation_warns(cpu_devices):
    """A hand-pinned lane count that does not divide the mesh drops budget;
    the split must say so (round-2 verdict item 7). Auto-resolved lane
    counts stay silent."""
    import warnings
    from strange_attractor_tpu.parallel.mesh import _split_lanes

    cfg = presets.poisson_saturne(lanes=100)
    with pytest.warns(UserWarning, match="does not divide"):
        assert _split_lanes(cfg, 100, 8) == 12
    cfg_auto = presets.poisson_saturne()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _split_lanes(cfg_auto, 1024, 8) == 128


def test_render_sequence_batched_empty_angles():
    from strange_attractor_tpu.render import render_sequence_batched

    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=10_000, lanes=64, chunk_steps=32, seed=5,
    )
    out = render_sequence_batched(cfg, [])
    assert out.shape == (0, 27, 48, 4) and out.dtype == np.uint16
    out8 = render_sequence_batched(cfg, [], transparent=False, eight_bit=True)
    assert out8.shape == (0, 27, 48, 3) and out8.dtype == np.uint8


def test_render_sequence_seeded_matches_batched():
    """A SEEDED per-frame sequence must fold the frame index into the base
    key (fresh trajectories per frame, like the reference's per-frame OS
    entropy draw) — and fold it exactly like render_sequence_batched, so
    the two paths produce identical frames. Before the fold, every
    per-frame render replayed PRNGKey(seed) and would disagree with the
    batched path on all frames but the first."""
    from strange_attractor_tpu.render import render_sequence, render_sequence_batched

    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=30_000, lanes=64, chunk_steps=32, seed=9,
    )
    per_frame = [img for _, img in render_sequence(cfg, 0.0, 3.0, 1.0)]
    assert len(per_frame) == 3  # angle_iter: 0, 1, 2
    batched = render_sequence_batched(cfg, [0.0, 1.0, 2.0])
    for a, b in zip(per_frame, batched):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy", [
    BinStrategy.KERNEL, BinStrategy.EXACT16_KERNEL, BinStrategy.DEPTH_KERNEL,
])
def test_merge_based_resume_equals_accumulation(strategy):
    """The property mesh resume rests on: folding a FRESH render into a
    standing state with runtime.merge is bit-identical to continuing the
    accumulation through the chunk loop — every plane update is the same
    commutative op the merge applies (count +, packed max, strict-> z-test
    with standing-wins ties)."""
    from strange_attractor_tpu.runtime import merge

    depth = strategy is BinStrategy.DEPTH_KERNEL
    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=60_000, lanes=128, chunk_steps=32,
        seed=5, bin_strategy=strategy,
        render=RenderKind.DEPTH if depth else RenderKind.GAS,
    )
    standing = render(cfg)
    key = jax.random.PRNGKey(123)
    resumed = render(cfg, standing, key)
    merged = merge(standing, render(cfg, None, key))
    for a, b in zip(resumed, merged):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("strategy", [BinStrategy.KERNEL, BinStrategy.DEPTH_KERNEL])
def test_render_sharded_resume(cpu_devices, strategy):
    """--load-state on a mesh: the standing accumulation folds into the
    sharded render (round-4 verdict item 5; the CLI used to fall back to a
    single device). Bit-equal to merging the sharded fresh render by hand,
    and the seeded no-key call derives the same content-based continuation
    key as the single-device path."""
    from strange_attractor_tpu.render import progressive_key
    from strange_attractor_tpu.runtime import merge

    depth = strategy is BinStrategy.DEPTH_KERNEL
    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=60_000, lanes=256, chunk_steps=32,
        seed=6, bin_strategy=strategy,
        render=RenderKind.DEPTH if depth else RenderKind.GAS,
    )
    standing = render(cfg)  # single-device accumulation, then resume on mesh
    key = progressive_key(cfg, standing)
    want = merge(standing, render_sharded(cfg, cpu_devices, key))
    got = render_sharded(cfg, cpu_devices, state=standing)
    for a, b in zip(got, want):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the resumed state kept accumulating (count grows / depth coverage)
    if depth:
        assert (np.asarray(got.zbuf) != -1.0).sum() >= (np.asarray(standing.zbuf) != -1.0).sum()
    else:
        assert np.asarray(got.count).sum() == 2 * np.asarray(standing.count).sum()


def test_render_sharded_resume_shape_mismatch(cpu_devices):
    from strange_attractor_tpu.runtime import RenderState

    cfg = presets.poisson_saturne(width=48, height=27, iterations=10_000,
                                  lanes=64, chunk_steps=16, seed=1)
    wrong = RenderState.blank((10, 10), BinStrategy.PACKED)
    with pytest.raises(ValueError, match="does not match config"):
        render_sharded(cfg, cpu_devices, state=wrong)


def test_render_sharded_grouped_bit_identical(cpu_devices, monkeypatch):
    """Grouped mesh dispatch (--preview-every's machinery, round-4 verdict
    item 6) must be bit-identical to the single-program mesh render: same
    per-device key folds, same chunk sequence — only the dispatch
    boundaries move. The progress callback sees monotone accumulation."""
    import importlib

    render_mod = importlib.import_module("strange_attractor_tpu.render")

    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=120_000, lanes=256, chunk_steps=16,
        seed=7, bin_strategy=BinStrategy.KERNEL,
    )
    key = jax.random.PRNGKey(3)
    want = render_sharded(cfg, cpu_devices, key)

    monkeypatch.setattr(render_mod, "DISPATCH_GROUP", 4)
    calls = []

    def on_progress(done, total, partial):
        calls.append((done, total, int(np.asarray(partial.count).sum())))

    got = render_sharded(cfg, cpu_devices, key, on_progress=on_progress)
    np.testing.assert_array_equal(np.asarray(got.count), np.asarray(want.count))
    np.testing.assert_array_equal(np.asarray(got.packed), np.asarray(want.packed))
    assert len(calls) >= 2
    assert calls[-1][0] == calls[-1][1]  # final callback reports completion
    sums = [c[2] for c in calls]
    assert sums == sorted(sums) and sums[-1] > sums[0]


def test_render_sharded_grouped_resume_preview(cpu_devices, monkeypatch):
    """Grouped dispatch + standing state: previews show standing + partial
    (the actual progressive image), and the result matches the
    single-program resume bit-for-bit."""
    import importlib

    render_mod = importlib.import_module("strange_attractor_tpu.render")

    cfg = presets.poisson_saturne(
        width=48, height=27, iterations=60_000, lanes=256, chunk_steps=16,
        seed=9, bin_strategy=BinStrategy.KERNEL,
    )
    standing = render(cfg)
    key = jax.random.PRNGKey(17)
    want = render_sharded(cfg, cpu_devices, key, state=standing)

    monkeypatch.setattr(render_mod, "DISPATCH_GROUP", 4)
    base = int(np.asarray(standing.count).sum())
    seen = []

    def on_progress(done, total, partial):
        seen.append(int(np.asarray(partial.count).sum()))

    got = render_sharded(cfg, cpu_devices, key, state=standing,
                         on_progress=on_progress)
    np.testing.assert_array_equal(np.asarray(got.count), np.asarray(want.count))
    np.testing.assert_array_equal(np.asarray(got.packed), np.asarray(want.packed))
    assert all(s > base for s in seen)  # previews include the standing state
