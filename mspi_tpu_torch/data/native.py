"""ctypes binding of the port to the C++ frame loader `native/mspi_loader.cc`:
libjpeg decode, PIL-compatible antialiased bilinear resize, and threaded
clip decoding.

Counterpart of `mspi_tpu/data/native.py`, with its own build: the first use
compiles the source with `g++ -O3 -fPIC -shared -std=c++17 ... -ljpeg
-lpthread` into `build/mspi_tpu_torch/libmspi_loader.so` (rebuilt when the
source is newer), and never writes under `native/`. Nothing falls back to
PIL here: a failed build raises with the compiler's output, a library that
does not load raises naming it, and a file that does not decode raises
naming it.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "mspi_loader.cc"
LIB_PATH = REPO_DIR / "build" / "mspi_tpu_torch" / "libmspi_loader.so"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")


def build() -> Path:
    """Compile SOURCE into LIB_PATH (through a temporary file in the same
    directory, so concurrent builds never load a half-written library)."""
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=LIB_PATH.parent)
    os.close(fd)
    cmd = ["g++", *CXXFLAGS, "-o", tmp, str(SOURCE), "-ljpeg", "-lpthread"]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed ({' '.join(cmd)}):\n"
                               f"{done.stdout}{done.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return LIB_PATH


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded library, built first if missing or older than SOURCE."""
    if not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime:
        build()
    try:
        handle = ctypes.CDLL(str(LIB_PATH))
    except OSError as e:  # e.g. libjpeg's runtime library missing on this machine
        raise OSError(f"native loader {LIB_PATH} (built from {SOURCE}) does not load: {e}") from e
    handle.mspi_decode_jpeg.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
                                        ctypes.c_int, ctypes.c_int]
    handle.mspi_decode_jpeg.restype = ctypes.c_int
    handle.mspi_decode_clip.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
    handle.mspi_decode_clip.restype = ctypes.c_int
    return handle


def _out_ptr(out: np.ndarray):
    return out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def load_frame_native(path: str, size: Tuple[int, int]) -> np.ndarray:
    """JPEG -> [h, w, 3] uint8 resized to size (h, w)."""
    h, w = size
    out = np.empty((h, w, 3), dtype=np.uint8)
    if lib().mspi_decode_jpeg(os.fsencode(path), _out_ptr(out), h, w) != 0:
        raise OSError(f"native loader could not decode {path}")
    return out


def load_clip_native(paths: Sequence[str], size: Tuple[int, int],
                     n_threads: int = 4) -> np.ndarray:
    """JPEGs -> [T, h, w, 3] uint8, decoded by the library's thread pool."""
    h, w = size
    out = np.empty((len(paths), h, w, 3), dtype=np.uint8)
    names = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    if lib().mspi_decode_clip(names, len(paths), _out_ptr(out), h, w, n_threads) != 0:
        for p in paths:  # name the first file that fails
            load_frame_native(p, size)
        raise OSError(f"native loader could not decode a frame of {list(paths)}")
    return out
