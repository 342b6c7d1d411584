"""A threaded JPEG / PNG decoder for whole dataset splits.

Counterpart of ``samnerf_tpu/native``: ``loader.cpp`` (this package's own
copy) decodes a list of files with libjpeg / libpng on a thread pool
straight into one preallocated [N, H, W, 3] uint8 buffer (RGBA over
white, optional box downscale).  It is built with the system C++ compiler
at first use into ``samnerf_tpu_torch/_build/`` (keyed by a hash of the
source; listed in ``.gitignore``) and loaded with :mod:`ctypes`.  This is
host decoding, not a device kernel.  Without a compiler or the libraries
:func:`get_loader` gives None and callers decode through PIL;
:func:`build_error` then says why (the missing tool, or the compiler's
exit code and the tail of its error output).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

COMPILER = "c++"
ERROR_TAIL_CHARS = 2000     # of the compiler's error output kept in the reason

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def _build() -> Tuple[Optional[Path], Optional[str]]:
    """(the built library, None), built now unless this source's build
    exists; (None, why) when the toolchain or a library is missing."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libloader_{digest}.so"
    if out.exists():
        return out, None
    if shutil.which(COMPILER) is None:
        return None, f"no {COMPILER} on PATH"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [COMPILER, "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE), "-o", str(tmp),
           "-ljpeg", "-lpng", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        tail = (e.stderr or e.stdout or "").strip()[-ERROR_TAIL_CHARS:]
        return None, f"{COMPILER} exited {e.returncode}: {tail}"
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        return None, f"{COMPILER} failed: {e}"
    os.replace(tmp, out)          # atomic: concurrent builds leave one file
    return out, None


def get_loader() -> Optional[ctypes.CDLL]:
    """The compiled library, or None if it cannot be built or loaded."""
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path, _error = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _error = f"loading {path.name} failed: {e}"
            return None
        lib.decode_images.restype = ctypes.c_int
        lib.decode_images.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """Why :func:`get_loader` gave None (None before the first try and
    after a build that loaded)."""
    return _error


def decode_images(paths: List, out_h: int, out_w: int, downscale: int = 1,
                  num_threads: Optional[int] = None) -> Optional[np.ndarray]:
    """JPEG / PNG files -> one [N, out_h, out_w, 3] uint8 array, each file
    box-downscaled by ``downscale``; None when the library is unavailable
    or a file fails to decode or has another size (callers then use PIL)."""
    lib = get_loader()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    threads = num_threads or min(16, os.cpu_count() or 1)
    rc = lib.decode_images(names, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                           out_h, out_w, downscale, threads)
    return out if rc == 0 else None
