"""Build + load the native C++ helpers (parallel deflate for PNG export).

The shared library is compiled on demand from the packaged
``strange_attractor_tpu/native/fastdeflate.cpp`` with the system ``g++`` into
a per-user cache directory, then loaded with ctypes (shipped as package data
so installed wheels keep the fast path).
Everything degrades gracefully: if the toolchain or zlib headers are missing,
callers fall back to the pure-Python writers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import zlib
from pathlib import Path
from typing import Optional

_SOURCE = Path(__file__).resolve().parent.parent / "native" / "fastdeflate.cpp"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _cache_dir() -> Path:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    d = Path(base) / "strange_attractor_tpu"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _build() -> Optional[ctypes.CDLL]:
    if not _SOURCE.exists():
        return None
    tag = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
    try:
        so = _cache_dir() / f"fastdeflate-{tag}.so"
    except OSError:
        # read-only HOME/XDG_CACHE_HOME (sandboxed CI): degrade to the
        # stdlib fallback instead of crashing the PNG export
        return None
    if not so.exists():
        # per-process tmp name: two cold-cache processes otherwise race on
        # one path — os.replace could promote a half-written .so (poisoning
        # the cache) and the loser crashes on a vanished tmp file
        tmp = so.with_suffix(f".tmp.{os.getpid()}.so")
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
            str(_SOURCE), "-o", str(tmp), "-lz", "-lpthread",
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.fastdeflate_zlib.restype = ctypes.c_long
    lib.fastdeflate_zlib.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long,
    ]
    lib.fastdeflate_png_filter.restype = ctypes.c_int
    lib.fastdeflate_png_filter.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build()
            _TRIED = True
        return _LIB


def zlib_compress_parallel(data: bytes, level: int = 6, threads: Optional[int] = None) -> bytes:
    """Compress to a zlib stream using all cores; stdlib fallback.

    Output is a standard zlib stream (decompressible by ``zlib.decompress``);
    parallelism only changes how deflate blocks are segmented.
    """
    if threads is None:
        threads = min(16, os.cpu_count() or 1)
    lib = get_lib()
    n = len(data)
    # single-stream stdlib wins on 1 core or small payloads
    if lib is None or n < (1 << 21) or threads < 2:
        return zlib.compress(data, level)
    cap = n + (n >> 9) + 64 + 16 * threads
    out = ctypes.create_string_buffer(cap)
    written = lib.fastdeflate_zlib(data, n, level, threads, out, cap)
    if written <= 0:
        return zlib.compress(data, level)
    return out.raw[:written]


def png_filter_adaptive(rows, bpp: int, threads: Optional[int] = None):
    """Native adaptive PNG scanline filter, or None if the lib is missing.

    ``rows`` is a C-contiguous (h, stride) uint8 array of raw scanlines;
    returns the h*(1+stride) filtered byte stream (filter byte + row each),
    byte-identical to export._filter_scanlines' numpy path (the fallback
    and test reference). C speed matters because the filter — not deflate —
    is the larger cost of a warm 1080p encode.
    """
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    assert rows.dtype == np.uint8 and rows.ndim == 2 and rows.flags.c_contiguous
    h, stride = rows.shape
    if threads is None:
        threads = min(16, os.cpu_count() or 1)
    out = ctypes.create_string_buffer(h * (1 + stride))
    rc = lib.fastdeflate_png_filter(
        rows.ctypes.data, h, stride, bpp, max(1, threads), out
    )
    if rc != 0:
        return None
    return out.raw
