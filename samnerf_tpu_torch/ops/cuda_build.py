"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with :mod:`ctypes`.
Builds happen at first use into ``samnerf_tpu_torch/_build/`` (listed in
``.gitignore``), keyed by a hash of the source, from the sources in this
checkout only.  A failed build raises.  :func:`build_all` starts one
``nvcc`` per source at once, so a fresh checkout builds in the time of
its slowest source.  ``ptxas``'s report of each kernel's registers,
spills and shared memory (``-Xptxas -v``) is kept beside the library and
read by :func:`kernel_resources`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("hash_encode", "attention_relpos")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return str(path)


def _target(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp path, target)
    or None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, target = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    target.with_suffix(".log").write_text(log)
    os.replace(tmp, target)        # atomic: a reader never sees half a file


def build_all() -> None:
    """Compile every kernel source, all ``nvcc`` processes in parallel."""
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        for name, s in started.items():
            _finish(name, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def nvcc_version() -> str:
    """The toolkit's release line (``nvcc --version``), e.g. "Cuda
    compilation tools, release 12.4, V12.4.131"."""
    out = subprocess.run([_nvcc(), "--version"], check=True, capture_output=True,
                         text=True).stdout
    return next((line.strip() for line in out.splitlines() if "release" in line),
                out.strip())


def kernel_resources(name: str) -> List[dict]:
    """Per kernel of ``csrc/<name>.cu`` (mangled name), as ``ptxas``
    reported them when this build of the source was compiled: registers
    a thread, spill stores and loads (bytes), stack frame and static shared
    memory (bytes).  Empty when the build's log is missing."""
    log = _target(name).with_suffix(".log")
    if not log.exists():
        return []
    rows, current = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = dict(kernel=m.group(1))
            rows.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            current["static_smem"] = int(s.group(1)) if s else 0
    return [r for r in rows if "registers" in r]
