"""Build the port's CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` of the package, one process per
source, all started together, and links them into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds). The
library's name carries a digest of the sources, the ``csrc/*.cuh`` headers
they share and the flags, so a stale
build is never loaded; the build writes to a temporary
name and renames, so a concurrent or interrupted build never leaves a
half-written library under the final name. A missing ``nvcc`` or a failed
compile raises: the kernels have no fallback on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# never fast math: the fills rely on true -inf borders and exact f32 adds;
# --fmad=false keeps each add and multiply rounded on its own, as in the
# plain PyTorch versions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # how long this process's compile took


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of aligntools_tpu_torch are built from source at "
        "first use"
    )


def library_path() -> str:
    """Where the build of the current sources (and the headers they
    include) lives."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                     + glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libkernels-{h.hexdigest()[:16]}.so")


def _run(procs) -> None:
    """Wait for every (cmd, Popen), killing any left on a timeout; raise
    if one failed."""
    try:
        outs = [p.communicate(timeout=600)[0] for _, p in procs]
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (cmd, p), out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")


def _compile(path: str) -> None:
    """One nvcc per source, all started together, then one link."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]

    def start(cmd):
        return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    try:
        _run([start([nvcc, *compile_flags, "-c", "-o", obj, src])
              for src, obj in zip(sources, objs)])
        _run([start([nvcc, *NVCC_FLAGS, "-o", tmp, *objs])])
        os.replace(tmp, path)
    finally:
        for f in (tmp, *objs):
            if os.path.exists(f):
                os.remove(f)


def load() -> ctypes.CDLL:
    """The loaded kernel library, compiled first when no build of the
    current sources exists."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                t0 = time.perf_counter()
                _compile(path)
                build_seconds = time.perf_counter() - t0
            _lib = ctypes.CDLL(path)
        return _lib
