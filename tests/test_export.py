"""Export tests: format conversion matrix and PNG/BMP/PAM writers."""

import os
import struct
import zlib

import numpy as np
import pytest

from strange_attractor_tpu.utils.export import (
    bmp_bytes,
    convert_format,
    pam_bytes,
    png_bytes,
    write_image,
)


def _decode_png(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    chunks = {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])[0]
        assert crc == zlib.crc32(tag + payload) & 0xFFFFFFFF
        chunks.setdefault(tag, b"")
        chunks[tag] += payload
        pos += 12 + length
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    ch = {2: 3, 6: 4}[ctype]
    raw = zlib.decompress(chunks[b"IDAT"])
    bpp = ch * (depth // 8)
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        row = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if ftype == 0:  # None
            pass
        elif ftype == 1:  # Sub (serial: each byte needs the reconstructed left)
            for x in range(bpp, stride):
                row[x] = (int(row[x]) + int(row[x - bpp])) & 0xFF
        elif ftype == 2:  # Up
            row = (row + prev).astype(np.uint8)
        elif ftype == 3:  # Average
            for x in range(stride):
                left = int(row[x - bpp]) if x >= bpp else 0
                row[x] = (int(row[x]) + (left + int(prev[x])) // 2) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                a = int(row[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (int(row[x]) + pred) & 0xFF
        else:
            raise AssertionError(f"unexpected filter {ftype}")
        out[y] = row
        prev = row
    if depth == 16:
        arr = out.reshape(h, w, ch, 2)
        return (arr[..., 0].astype(np.uint16) << 8) | arr[..., 1]
    return out.reshape(h, w, ch)


@pytest.fixture
def img16():
    rng = np.random.default_rng(0)
    return rng.integers(0, 65536, (5, 7, 4)).astype(np.uint16)


@pytest.mark.parametrize("transparent", [True, False])
@pytest.mark.parametrize("eight_bit", [True, False])
def test_convert_matrix(img16, transparent, eight_bit):
    out = convert_format(img16, transparent, eight_bit)
    assert out.shape[2] == (4 if transparent else 3)
    assert out.dtype == (np.uint8 if eight_bit else np.uint16)
    if eight_bit:
        # round(v * 255 / 65535)
        want = np.round(img16[..., : out.shape[2]].astype(np.float64) * 255 / 65535)
        np.testing.assert_array_equal(out, want.astype(np.uint8))


@pytest.mark.parametrize("ch", [3, 4])
@pytest.mark.parametrize("depth", [8, 16])
def test_png_roundtrip(img16, ch, depth):
    arr = img16[..., :ch]
    if depth == 8:
        arr = (arr >> 8).astype(np.uint8)
    data = png_bytes(arr)
    got = _decode_png(data)
    np.testing.assert_array_equal(got, arr)


def test_png_adaptive_filtering_shrinks_gradients():
    """The encoder uses spec-heuristic adaptive filtering like the reference
    (FilterType::Adaptive, src/bin/main.rs:84-88): on smooth gradients it must
    beat a filter-None encoding, and still round-trip exactly."""
    x = np.linspace(0, 65535, 96)[None, :, None]
    arr = np.ascontiguousarray(np.broadcast_to(x, (54, 96, 3))).astype(np.uint16)
    data = png_bytes(arr)
    np.testing.assert_array_equal(_decode_png(data), arr)
    none_only = zlib.compress(
        b"".join(b"\x00" + arr[y].astype(">u2").tobytes() for y in range(54)), 6
    )
    assert len(data) < len(none_only), (len(data), len(none_only))


def test_bmp_roundtrip_via_pil(img16, tmp_path):
    from PIL import Image

    arr8 = (img16 >> 8).astype(np.uint8)
    # RGB 24bpp
    p = tmp_path / "t.bmp"
    p.write_bytes(bmp_bytes(arr8[..., :3]))
    got = np.asarray(Image.open(p).convert("RGB"))
    np.testing.assert_array_equal(got, arr8[..., :3])
    # RGBA 32bpp
    p2 = tmp_path / "t2.bmp"
    p2.write_bytes(bmp_bytes(arr8))
    got2 = np.asarray(Image.open(p2).convert("RGBA"))
    np.testing.assert_array_equal(got2, arr8)


def test_pam_roundtrip(img16):
    arr8 = (img16 >> 8).astype(np.uint8)
    data = pam_bytes(arr8)
    header, _, body = data.partition(b"ENDHDR\n")
    assert b"P7" in header and b"DEPTH 4" in header and b"MAXVAL 255" in header
    got = np.frombuffer(body, np.uint8).reshape(arr8.shape)
    np.testing.assert_array_equal(got, arr8)
    # 16-bit PAM is big-endian
    data16 = pam_bytes(img16)
    _, _, body16 = data16.partition(b"ENDHDR\n")
    got16 = np.frombuffer(body16, ">u2").reshape(img16.shape).astype(np.uint16)
    np.testing.assert_array_equal(got16, img16)


def test_write_image_driver(img16, tmp_path):
    out = write_image(tmp_path / "frame", img16, fmt="png", transparent=True,
                      eight_bit=False, silent=True)
    assert out.name == "frame.png" and out.exists()
    got = _decode_png(out.read_bytes())
    np.testing.assert_array_equal(got, img16)
    with pytest.raises(ValueError):
        write_image(tmp_path / "x", img16, fmt="tiff")


def test_native_parallel_deflate_roundtrip():
    """Native lib (if buildable here) must produce valid zlib streams; the
    call must degrade to stdlib when unavailable."""
    import zlib

    from strange_attractor_tpu.utils.native import get_lib, zlib_compress_parallel

    if os.environ.get("SAR_REQUIRE_NATIVE") and get_lib() is None:
        pytest.fail("SAR_REQUIRE_NATIVE set but the native lib did not "
                    "build/load — CI must exercise the native path")
    data = bytes(range(256)) * 20000  # ~5MB, forces the large-payload path
    out = zlib_compress_parallel(data, level=6, threads=4)
    assert zlib.decompress(out) == data
    out1 = zlib_compress_parallel(data, level=6, threads=1)  # stdlib path
    assert zlib.decompress(out1) == data


def test_completion_zsh():
    from strange_attractor_tpu.cli import build_parser
    from strange_attractor_tpu.utils.completion import completion_script

    s = completion_script("zsh", build_parser())
    assert "#compdef" in s and "--iterations" in s


def _parse_apng_chunks(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos+4])
        tag = data[pos+4:pos+8]
        payload = data[pos+8:pos+8+length]
        assert struct.unpack(">I", data[pos+8+length:pos+12+length])[0] == \
            zlib.crc32(tag + payload) & 0xFFFFFFFF
        chunks.append((tag, payload))
        pos += 12 + length
    return chunks


def test_apng_structure(img16):
    from strange_attractor_tpu.utils.export import apng_bytes

    frames = np.stack([img16, img16 // 2, img16 // 4])
    data = apng_bytes(frames, fps=24)
    chunks = _parse_apng_chunks(data)
    tags = [t for t, _ in chunks]
    assert tags[0] == b"IHDR" and tags[-1] == b"IEND"
    assert tags.count(b"acTL") == 1 and tags.count(b"fcTL") == 3
    assert tags.count(b"IDAT") == 1 and tags.count(b"fdAT") == 2
    actl = next(p for t, p in chunks if t == b"acTL")
    assert struct.unpack(">II", actl) == (3, 0)
    # sequence numbers strictly increasing across fcTL/fdAT
    seqs = [struct.unpack(">I", p[:4])[0] for t, p in chunks if t in (b"fcTL", b"fdAT")]
    assert seqs == sorted(seqs) == list(range(len(seqs)))
    # the APNG's OWN first frame decodes like a plain PNG: rebuild a
    # standalone PNG from its IHDR + IDAT and compare pixels (a corrupt
    # fdAT/IDAT payload would pass the chunk-structure checks above)
    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = next(p for t, p in chunks if t == b"IHDR")
    idat = next(p for t, p in chunks if t == b"IDAT")
    plain = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
             + chunk(b"IDAT", idat) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(_decode_png(plain), frames[0])
    # and the second frame's fdAT payload (past the 4-byte sequence
    # number) is valid deflate data for the full canvas
    fdat = next(p for t, p in chunks if t == b"fdAT")
    plain2 = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
              + chunk(b"IDAT", fdat[4:]) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(_decode_png(plain2), frames[1])


def test_apng_cli(tmp_path):
    from strange_attractor_tpu.cli import main as cli_main

    out = tmp_path / "anim"
    fast = ["-i", "4000", "-w", "32", "-h", "18", "--lanes", "32",
            "--chunk-steps", "16", "--seed", "1", "-q", "-8"]
    assert cli_main(fast + ["-o", str(out), "sequence", "-s", "0", "-e", "3",
                            "-d", "1", "--apng", "--fps", "10"]) == 0
    data = (tmp_path / "anim.apng").read_bytes()
    chunks = _parse_apng_chunks(data)
    assert sum(1 for t, _ in chunks if t == b"fcTL") == 3


def test_png_noncontiguous_input(img16):
    """jax.device_get can hand back layouts whose last axis is not
    contiguous, which broke the .view(uint8) reinterpret in the scanline
    filter once. Exercise the filter directly with such a layout, plus
    png_bytes with a strided view."""
    from strange_attractor_tpu.utils.export import _filter_scanlines

    h, stride = 5, 7 * 8
    base = np.arange(h * stride * 2, dtype=np.uint8).reshape(h, stride, 2)
    hostile = base[:, :, 0]  # last-axis stride 2: not contiguous
    assert hostile.strides[-1] != hostile.itemsize
    out = _filter_scanlines(hostile, h)
    want = _filter_scanlines(np.ascontiguousarray(hostile), h)
    assert out == want

    view = img16[:, ::-1]  # reversed-stride view through the full writer
    assert not view.flags["C_CONTIGUOUS"]
    got = _decode_png(png_bytes(view))
    np.testing.assert_array_equal(got, np.ascontiguousarray(view))


def test_convert_format_device_twin_and_idempotence():
    """Device-side conversion == host conversion, and write path's host
    convert_format is a no-op on pre-converted input."""
    import jax.numpy as jnp

    from strange_attractor_tpu.utils.export import convert_format, convert_format_device

    rng = np.random.default_rng(5)
    img = rng.integers(0, 65536, (7, 9, 4), dtype=np.uint16)
    for transparent in (False, True):
        for eight_bit in (False, True):
            host = convert_format(img, transparent, eight_bit)
            dev = np.asarray(convert_format_device(jnp.asarray(img), transparent, eight_bit))
            np.testing.assert_array_equal(host, dev)
            # idempotent: feeding the converted array back changes nothing
            np.testing.assert_array_equal(convert_format(dev, transparent, eight_bit), host)


def test_convert_device_multiply_shift_exact_all_values():
    """The device path's strength-reduced ((v+128)*65281)>>24 must equal the
    host's (v*255+32767)//65535 for EVERY uint16 value (see the proof in
    convert_format_device's docstring)."""
    import jax.numpy as jnp

    from strange_attractor_tpu.utils.export import convert_format, convert_format_device

    allv = np.arange(65536, dtype=np.uint16).reshape(256, 256, 1)
    img = np.repeat(allv, 3, axis=2).astype(np.uint16)
    host = convert_format(img, transparent=False, eight_bit=True)
    dev = np.asarray(convert_format_device(jnp.asarray(img), False, True))
    np.testing.assert_array_equal(host, dev)


def test_fetch_image_bitcast_roundtrip():
    """fetch_image's u32-bitcast fast path must be byte-identical to the
    direct device_get for u8 and u16 images (and fall back cleanly for
    shapes whose byte count is not a multiple of 4)."""
    import jax.numpy as jnp

    from strange_attractor_tpu.utils.export import fetch_image

    rng = np.random.default_rng(11)
    u8 = rng.integers(0, 256, (27, 48, 4), np.uint8)       # divisible by 4
    u16 = rng.integers(0, 65536, (27, 48, 4), np.uint16)
    odd = rng.integers(0, 256, (5, 5, 3), np.uint8)        # 75 bytes: fallback
    # >= 2^21 bytes with an even word count: exercises the two-band
    # overlapped-transfer path, not just the single device_get
    big = rng.integers(0, 256, (1024, 512, 4), np.uint8)
    for arr in (u8, u16, odd, big):
        np.testing.assert_array_equal(fetch_image(jnp.asarray(arr)), arr)


def test_fetch_image_band_counts(monkeypatch):
    """Any band count — including ones that do not divide the word count —
    reassembles the exact bytes; the env override is honored."""
    import jax.numpy as jnp

    from strange_attractor_tpu.utils.export import fetch_image

    rng = np.random.default_rng(12)
    # 525312 u32 words: % 5 == 2 and % 7 == 4 exercise the uneven split
    # (first remainder bands take the extra word); 3 and 16 divide evenly
    big = rng.integers(0, 256, (1024, 513, 4), np.uint8)
    for bands in (1, 2, 3, 5, 7, 16):
        np.testing.assert_array_equal(fetch_image(jnp.asarray(big), bands=bands), big)
    monkeypatch.setenv("SAR_FETCH_BANDS", "3")
    np.testing.assert_array_equal(fetch_image(jnp.asarray(big)), big)
    # explicit bands= is honored even under the 2 MB auto-band threshold
    small = rng.integers(0, 256, (64, 64, 4), np.uint8)
    np.testing.assert_array_equal(fetch_image(jnp.asarray(small), bands=3), small)


def test_native_png_filter_matches_numpy():
    """The native C++ adaptive filter must be byte-identical to the numpy
    reference path on every geometry: both depths, both channel counts,
    flat / gradient / random content, single-row, and narrow images."""
    from strange_attractor_tpu.utils.export import (
        _bytes_per_pixel,
        _filter_scanlines_numpy,
    )
    from strange_attractor_tpu.utils.native import get_lib, png_filter_adaptive

    if get_lib() is None:
        if os.environ.get("SAR_REQUIRE_NATIVE"):
            pytest.fail("SAR_REQUIRE_NATIVE set but the native lib did not "
                        "build/load — CI must exercise the native path")
        pytest.skip("native lib unavailable (no toolchain)")
    rng = np.random.default_rng(7)
    grad = np.linspace(0, 65535, 40 * 30 * 4).reshape(40, 30, 4)
    cases = [
        rng.integers(0, 256, (25, 17, 3), np.uint8),
        rng.integers(0, 65536, (25, 17, 4), np.uint16),
        np.zeros((8, 8, 3), np.uint8),
        grad.astype(np.uint16),
        (grad[..., :3] / 257).astype(np.uint8),
        rng.integers(0, 256, (1, 5, 4), np.uint8),   # single row
        rng.integers(0, 65536, (7, 1, 3), np.uint16),  # single column
    ]
    for arr in cases:
        raw = arr if arr.dtype == np.uint8 else arr.astype(">u2")
        h = raw.shape[0]
        rows = np.ascontiguousarray(raw).reshape(h, -1).view(np.uint8).reshape(h, -1)
        bpp = _bytes_per_pixel(raw)
        native = png_filter_adaptive(np.ascontiguousarray(rows), bpp)
        assert native is not None
        assert native == _filter_scanlines_numpy(rows, bpp)


def test_colorize_convert_fetch_banded_exact():
    """The banded colorize+convert+fetch pipeline must be bit-identical to
    the unbanded colorize -> host convert path for every render kind,
    deliverable shape, and band edge case (snapping, bands=1, odd bands,
    a band byte count that defeats the u32 bitcast)."""
    import jax

    from strange_attractor_tpu.config import BinStrategy, RenderKind
    from strange_attractor_tpu.models import presets
    from strange_attractor_tpu.render import colorize, colorize_convert_fetch, render

    cases = [
        # (strategy, render kind, w, h, transparent, eight_bit, bands)
        (BinStrategy.PACKED, RenderKind.GAS, 64, 36, False, True, 4),
        (BinStrategy.PACKED, RenderKind.GAS, 64, 36, True, False, 7),  # snaps to 6
        (BinStrategy.EXACT, RenderKind.GAS, 64, 36, True, True, 3),
        (BinStrategy.DEPTH, RenderKind.DEPTH, 64, 36, False, False, 2),
        (BinStrategy.PACKED, RenderKind.GAS, 64, 36, False, False, 1),  # plain path
        # rows*w*c = 3*47*3 odd: the band program's u16 bitcast falls back
        (BinStrategy.PACKED, RenderKind.GAS, 47, 9, False, False, 3),
    ]
    for strategy, kind, w, h, transparent, eight_bit, bands in cases:
        cfg = presets.poisson_saturne(
            width=w, height=h, iterations=20_000, lanes=64, chunk_steps=32,
            seed=3, bin_strategy=strategy, render=kind,
        )
        st = render(cfg)
        expected = convert_format(
            np.asarray(jax.device_get(colorize(cfg, st))), transparent, eight_bit
        )
        got = colorize_convert_fetch(
            cfg, st, transparent=transparent, eight_bit=eight_bit, bands=bands
        )
        assert got.dtype == expected.dtype and got.shape == expected.shape
        np.testing.assert_array_equal(got, expected)

    # a DEPTH (z-only) state asked to colorize as GAS must raise the same
    # curated ValueError as the plain path, not a NoneType crash in stats
    cfg = presets.poisson_saturne(
        width=64, height=36, iterations=10_000, lanes=64, chunk_steps=32,
        seed=3, bin_strategy=BinStrategy.DEPTH, render=RenderKind.DEPTH,
    )
    st = render(cfg)
    with pytest.raises(ValueError, match="cannot be colorized as a Gas"):
        colorize_convert_fetch(
            cfg.replace(render=RenderKind.GAS), st,
            transparent=False, eight_bit=True, bands=4,
        )


def test_apng_fractional_fps_delay(img16):
    """fcTL encodes the frame delay as an exact u16 rational: fps=12.5 must
    give 2/25 s (the old round(fps) denominator played 83.3 ms instead of
    80), fps=0.4 gives 5/2 s."""
    from strange_attractor_tpu.utils.export import apng_bytes

    frames = np.stack([img16, img16])
    for fps, want in ((12.5, (2, 25)), (0.4, (5, 2)), (24, (1, 24))):
        chunks = _parse_apng_chunks(apng_bytes(frames, fps=fps))
        fctl = next(p for t, p in chunks if t == b"fcTL")
        num, den = struct.unpack(">HH", fctl[20:24])
        assert (num, den) == want, (fps, num, den)
