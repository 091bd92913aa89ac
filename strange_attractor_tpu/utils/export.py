"""Image export: PNG (8/16-bit), BMP (8-bit), PAM (8/16-bit).

Mirrors the reference CLI's export matrix (src/bin/main.rs:27-104): the base
render is 16-bit RGBA; (transparent, 8-bit) flags select Rgba16 / Rgb16 /
Rgba8 / Rgb8; the container is PNG by default, or PAM / BMP on request.

Writers are dependency-free (stdlib zlib/struct): the reference's ``image``
crate equivalents. 16-bit PNG samples are big-endian per the PNG spec.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def convert_format(image_u16: np.ndarray, transparent: bool, eight_bit: bool) -> np.ndarray:
    """Apply the (transparent, 8-bit) conversion matrix (main.rs:52-57).

    ``image_u16`` is (H, W, 4) uint16. Dropping alpha slices the array;
    16->8-bit scales with rounding (``round(v * 255 / 65535)``), matching the
    image crate's normalized channel conversion.

    Idempotent: input already converted (by :func:`convert_format_device`
    before the host fetch) passes through unchanged.
    """
    img = image_u16 if (transparent or image_u16.shape[-1] == 3) else image_u16[..., :3]
    if eight_bit and img.dtype != np.uint8:
        img = ((img.astype(np.uint32) * 255 + 32767) // 65535).astype(np.uint8)
    return img


def convert_format_device(image_u16, transparent: bool, eight_bit: bool):
    """jnp twin of :func:`convert_format`, run on device BEFORE the host
    fetch: a 1080p u16 RGBA frame is ~16.6 MB to copy to the host, the
    8-bit RGB equivalent 6.2 MB (bit-identical conversion semantics —
    same round(v*255/65535) as the host path).

    The division is strength-reduced by hand to a multiply and a shift,
    which every backend vectorizes. For v in [0, 65535],
    ``(v*255 + 32767) // 65535 == (v + 128) // 257`` (65535 = 255*257 and
    the numerators can only differ in floor when 255*(v mod 257) lands in
    [32768, 32895), i.e. v mod 257 in [128.5, 129) — impossible), and
    ``x // 257 == (x * 65281) >> 24`` for x <= 65663 (65281*257 = 2^24 + 1,
    so the quotient picks up an error term x/(257*2^24) < 1.6e-5 that can
    never push frac(x/257) <= 256/257 past an integer). Both steps are
    exact; test_export pins all 65536 values against the host path.
    """
    import jax.numpy as jnp

    img = image_u16 if transparent else image_u16[..., :3]
    if eight_bit:
        img = (((img.astype(jnp.uint32) + 128) * 65281) >> 24).astype(jnp.uint8)
    return img


def _resolve_fetch_bands(bands: int | None, nbytes: int, words: int) -> int:
    """Band count for a host fetch: explicit arg > ``SAR_FETCH_BANDS`` env >
    8 (tuned on the system's first accelerator; not yet measured on the
    H100, ROADMAP 3.2). Without an explicit arg, small
    transfers (< 2 MB) go in one piece — the per-transfer bookkeeping the
    bands amortize only matters on multi-MB frames — but an explicit
    ``bands=`` is always honored (probes sweep small frames too)."""
    import os

    if bands is None:
        bands = int(os.environ.get("SAR_FETCH_BANDS", "8"))
        if nbytes < (1 << 21):
            bands = 1
    return max(1, min(int(bands), words))


def fetch_image(img, bands: int | None = None) -> np.ndarray:
    """``device_get`` an image via a uint32 bitcast.

    Packs trailing bytes into u32 words on device, fetches, and
    reinterprets on the host, in ``bands`` in-flight transfers (override
    via ``SAR_FETCH_BANDS``). Both were worth it on the slow device link of
    the system's first accelerator; on the H100 neither is measured yet
    (ROADMAP 3.2). Bit-exact: XLA's bitcast_convert_type composes
    minor-most bytes little-endian, matching the host view on every
    supported platform (asserted against the direct fetch in tests).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    img = jnp.asarray(img)
    itemsize = img.dtype.itemsize
    per = 4 // itemsize
    n = int(np.prod(img.shape))
    if itemsize >= 4 or n * itemsize % 4:
        return np.asarray(jax.device_get(img))
    packed = lax.bitcast_convert_type(img.reshape(-1, per), jnp.uint32)
    words = packed.shape[0]
    nbands = _resolve_fetch_bands(bands, n * itemsize, words)
    if nbands > 1:
        # equal-ish contiguous slices; the first (words % nbands) take the
        # extra word, so any band count works on any frame size
        base, extra = divmod(words, nbands)
        offsets = [0]
        for i in range(nbands):
            offsets.append(offsets[-1] + base + (1 if i < extra else 0))
        parts = [packed[offsets[i]: offsets[i + 1]] for i in range(nbands)]
        for b in parts:
            b.copy_to_host_async()
        host = np.concatenate([np.asarray(jax.device_get(b)) for b in parts])
    else:
        host = np.asarray(jax.device_get(packed))
    return np.ascontiguousarray(host).view(img.dtype).reshape(img.shape)


# ---------------------------------------------------------------- PNG ----


def _png_geometry(arr: np.ndarray):
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4), got {arr.shape}")
    h, w, ch = arr.shape
    if arr.dtype == np.uint8:
        depth, raw = 8, arr
    elif arr.dtype == np.uint16:
        depth, raw = 16, arr.astype(">u2")
    else:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    color_type = 6 if ch == 4 else 2
    return h, w, depth, color_type, raw


def _filter_scanlines(raw: np.ndarray, h: int) -> bytes:
    """Adaptive per-row PNG filtering (``FilterType::Adaptive``, like the
    reference encoder, src/bin/main.rs:84-88): each scanline tries all five
    standard filters (None/Sub/Up/Average/Paeth) and keeps the one with the
    smallest sum of absolute signed residuals — the spec's
    minimum-sum-of-absolute-differences heuristic.

    Dispatches to the native C++ filter (utils/native.py — the filter, not
    deflate, is the warm 1080p encode floor); falls back to the vectorized
    numpy path below, which is also the byte-for-byte test reference.
    """
    # jax.device_get can hand back non-contiguous strided views (padded
    # device layouts); .view() below needs contiguous memory
    raw = np.ascontiguousarray(raw)
    rows = raw.reshape(h, -1).view(np.uint8).reshape(h, -1)
    bpp = _bytes_per_pixel(raw)
    if h > 0:
        from .native import png_filter_adaptive

        out = png_filter_adaptive(np.ascontiguousarray(rows), bpp)
        if out is not None:
            return out
    return _filter_scanlines_numpy(rows, bpp)


def _filter_scanlines_numpy(rows: np.ndarray, bpp: int) -> bytes:
    """The pure-numpy adaptive filter: all five candidates as whole-image
    vectorized ops. Fallback when the native lib is unavailable, and the
    reference implementation the native path is pinned against in tests."""
    h, stride = rows.shape
    # (H, stride) u8 neighbours; the spec treats the row above row 0 and the
    # pixel left of column 0 as zeros
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    upleft = np.zeros_like(rows)
    upleft[1:, bpp:] = rows[:-1, :-bpp]

    cand = np.empty((5, h, stride), np.uint8)
    cand[0] = rows
    cand[1] = rows - left
    cand[2] = rows - up
    # average: floor((left + up) / 2) in full precision, then mod-256 diff
    cand[3] = rows - ((left.astype(np.uint16) + up) >> 1).astype(np.uint8)
    # Paeth predictor (PNG spec): nearest of left/up/upleft to left+up-upleft
    p = left.astype(np.int16) + up - upleft
    pa, pb, pc = (np.abs(p - t) for t in (left, up, upleft))
    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    cand[4] = rows - pred

    # minimum sum of absolute *signed* residuals, per the spec heuristic
    # (one candidate at a time: a (5, H, stride) int widening would cost
    # hundreds of MB at 1080p RGBA16)
    mag = np.empty((5, h), np.int64)
    for i in range(5):
        c = cand[i].astype(np.int32)
        mag[i] = np.minimum(c, 256 - c).sum(axis=1)
    pick = mag.argmin(axis=0)

    filtered = np.empty((h, 1 + stride), np.uint8)
    filtered[:, 0] = pick
    filtered[:, 1:] = np.take_along_axis(cand, pick[None, :, None], axis=0)[0]
    return filtered.tobytes()


def _bytes_per_pixel(raw: np.ndarray) -> int:
    """Bytes per pixel of the pre-serialization (H, W, C) sample array."""
    return raw.shape[-1] * raw.itemsize


def _chunk(tag: bytes, payload: bytes) -> bytes:
    out = struct.pack(">I", len(payload)) + tag + payload
    return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)


def png_bytes(arr: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) uint8/uint16 as a PNG byte string."""
    h, w, depth, color_type, raw = _png_geometry(arr)
    from .native import zlib_compress_parallel

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    idat = zlib_compress_parallel(_filter_scanlines(raw, h), 6)
    return b"".join(
        [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", ihdr), _chunk(b"IDAT", idat), _chunk(b"IEND", b"")]
    )


def read_png(data: bytes) -> np.ndarray:
    """Decode a non-interlaced 8/16-bit RGB(A) PNG — what :func:`png_bytes`
    writes — to an (H, W, C) uint8/uint16 array.

    Average and Paeth rows depend on the reconstructed pixel to the left and
    the row above, so pixels are reconstructed along anti-diagonals
    (row + column = const), each diagonal as one vectorized step."""
    import struct

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8:pos + 8 + length]
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    if ctype not in (2, 6) or depth not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG (color type {ctype}, depth {depth})")
    ch = 3 if ctype == 2 else 4
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    ftype = raw[:, 0].astype(np.int32)
    if (ftype > 4).any():
        raise ValueError("bad PNG filter type")
    filt = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # zero row/column padding
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ftype[y][:, None], [np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        out[y + 1, x + 1] = (filt[y, x] + pred) & 0xFF
    img = out[1:, 1:].astype(np.uint8).reshape(h, w, ch, depth // 8)
    if depth == 16:
        return (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    return img[..., 0]


def apng_bytes(frames: np.ndarray, fps: float = 30.0, loops: int = 0) -> bytes:
    """Encode (F, H, W, 3|4) uint8/uint16 frames as an animated PNG.

    Goes beyond the reference (which writes one file per sequence frame,
    src/bin/main.rs:496-512): the whole animation lands in one APNG that any
    modern viewer plays. ``loops=0`` means infinite.
    """
    from .native import zlib_compress_parallel

    if frames.ndim != 4 or frames.shape[0] < 1:
        raise ValueError(f"expected (F, H, W, C) frames, got {frames.shape}")
    h, w, depth, color_type, _ = _png_geometry(frames[0])

    # exact rational frame delay: delay_num/delay_den seconds per frame.
    # Rounding fps to an integer denominator lost fractional rates entirely
    # (fps=0.4 played 2.5x fast, 12.5 -> 83.3 ms instead of 80)
    from fractions import Fraction

    if not fps > 0:
        raise ValueError(f"fps must be positive, got {fps!r}")
    s = 1.0 / fps  # seconds per frame
    delay_den = Fraction(s).limit_denominator(65535).denominator
    if round(s * delay_den) > 65535:  # both fcTL fields are u16
        delay_den = max(1, int(65535 // s))
    # delay_num 0 is spec'd "render as fast as possible" — right for
    # fps beyond the u16 rational's resolution
    delay_num = min(65535, round(s * delay_den))
    out = [b"\x89PNG\r\n\x1a\n"]
    out.append(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)))
    out.append(_chunk(b"acTL", struct.pack(">II", frames.shape[0], loops)))
    seq = 0
    for f, frame in enumerate(frames):
        _, _, _, _, raw = _png_geometry(frame)
        fctl = struct.pack(
            ">IIIIIHHBB", seq, w, h, 0, 0, delay_num, delay_den, 0, 0
        )  # full-canvas frame, 1/fps rational delay, dispose none, blend source
        out.append(_chunk(b"fcTL", fctl))
        seq += 1
        data = zlib_compress_parallel(_filter_scanlines(raw, h), 6)
        if f == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def write_apng(path, frames: np.ndarray, fps: float = 30.0) -> None:
    Path(path).write_bytes(apng_bytes(frames, fps))


def write_png(path, arr: np.ndarray) -> None:
    Path(path).write_bytes(png_bytes(arr))


# ---------------------------------------------------------------- BMP ----


def bmp_bytes(arr: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) uint8 as BMP (24/32 bpp, bottom-up, BGR[A])."""
    if arr.dtype != np.uint8:
        raise ValueError("BMP export requires 8-bit data (reference CLI constraint)")
    h, w, ch = arr.shape
    if ch == 4:
        bgra = arr[..., [2, 1, 0, 3]]
        row_bytes = bgra[::-1].tobytes()
        bpp, compression = 32, 3  # BI_BITFIELDS
        # BITMAPV4-style masks for BGRA
        extra = struct.pack("<IIII", 0x00FF0000, 0x0000FF00, 0x000000FF, 0xFF000000)
        header_size = 40 + 16
    else:
        bgr = arr[..., [2, 1, 0]]
        pad = (-(w * 3)) % 4
        rows = [bgr[y].tobytes() + b"\x00" * pad for y in range(h - 1, -1, -1)]
        row_bytes = b"".join(rows)
        bpp, compression = 24, 0
        extra = b""
        header_size = 40
    pixel_offset = 14 + header_size
    file_size = pixel_offset + len(row_bytes)
    file_header = struct.pack("<2sIHHI", b"BM", file_size, 0, 0, pixel_offset)
    info = struct.pack(
        "<IiiHHIIiiII", header_size, w, h, 1, bpp, compression, len(row_bytes), 2835, 2835, 0, 0
    )
    return file_header + info + extra + row_bytes


def write_bmp(path, arr: np.ndarray) -> None:
    Path(path).write_bytes(bmp_bytes(arr))


# ---------------------------------------------------------------- PAM ----


def pam_bytes(arr: np.ndarray) -> bytes:
    """Encode (H, W, 3|4) uint8/uint16 as PAM (P7 ArbitraryMap,
    reference: main.rs:64-70)."""
    h, w, ch = arr.shape
    maxval = 255 if arr.dtype == np.uint8 else 65535
    tupltype = "RGB_ALPHA" if ch == 4 else "RGB"
    header = (
        f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {ch}\nMAXVAL {maxval}\n"
        f"TUPLTYPE {tupltype}\nENDHDR\n"
    ).encode()
    data = arr.tobytes() if arr.dtype == np.uint8 else arr.astype(">u2").tobytes()
    return header + data


def write_pam(path, arr: np.ndarray) -> None:
    Path(path).write_bytes(pam_bytes(arr))


# ------------------------------------------------------------- driver ----


def write_image(
    base_path,
    image_u16: np.ndarray,
    *,
    fmt: str = "png",
    transparent: bool = True,
    eight_bit: bool = False,
    silent: bool = True,
    announce: bool = True,
) -> Path:
    """Convert + write; returns the final path with extension
    (reference: main.rs:40-100).

    ``silent`` gates the progress prints like the reference's flag;
    "Wrote image to ..." prints even when silent (main.rs:99 sits outside
    the ``!silent`` gates — preserved for parity). ``announce=False``
    suppresses it too, for callers like the CLI's --preview-every loop
    that would otherwise print once per preview tick."""
    if not silent:
        print("Converting image format.")
    arr = convert_format(image_u16, transparent, eight_bit)
    path = Path(base_path).with_suffix("." + fmt)
    if not silent:
        print("Rendering complete. Writing file.")
    if fmt == "png":
        write_png(path, arr)
    elif fmt == "bmp":
        write_bmp(path, arr)
    elif fmt == "pam":
        write_pam(path, arr)
    else:
        raise ValueError(f"unknown format {fmt!r} (png, bmp, pam)")
    if announce:
        print(f"Wrote image to '{path}'.")
    return path
