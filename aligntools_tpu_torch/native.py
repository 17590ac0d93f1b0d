"""ctypes binding of the repository's C++ FASTA/FASTQ parser.

The parser half of ``aligntools_tpu/native.py``. ``g++`` compiles
``native/aligntools_native.cpp`` (the repository's own source, which the
JAX package builds with ``make -C native``) at first use into
``aligntools_tpu_torch/_build/``, under a name that carries a digest of the
source and the flags. The source's host traceback walkers are not bound:
the port walks on the device (``engine/device_tb.py``). Without a compiler
or zlib, or with ``ALIGNTOOLS_NO_NATIVE=1``, ``parse_records_native``
returns None and ``io.fasta`` parses in Python, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_REPO, "native", "aligntools_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libparse-{h.hexdigest()[:16]}.so")


def _compile(path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE, "-lz"],
                           capture_output=True, timeout=300)
        if r.returncode != 0:
            return False
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The loaded parser library, or None when it cannot be built (or
    ALIGNTOOLS_NO_NATIVE is set)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("ALIGNTOOLS_NO_NATIVE") or not os.path.exists(
                SOURCE):
            return None
        path = library_path()
        if not os.path.exists(path) and not _compile(path):
            return None
        lib = ctypes.CDLL(path)
        lib.at_parse.restype = ctypes.c_void_p
        lib.at_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.at_parse_error.restype = ctypes.c_int
        lib.at_parse_error.argtypes = [ctypes.c_void_p]
        lib.at_num_records.restype = ctypes.c_int64
        lib.at_num_records.argtypes = [ctypes.c_void_p]
        lib.at_arena.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.at_arena.argtypes = [ctypes.c_void_p]
        lib.at_arena_size.restype = ctypes.c_int64
        lib.at_arena_size.argtypes = [ctypes.c_void_p]
        lib.at_records_meta.restype = ctypes.POINTER(ctypes.c_int64)
        lib.at_records_meta.argtypes = [ctypes.c_void_p]
        lib.at_free.restype = None
        lib.at_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def parse_records_native(path: str, max_records: int = -1):
    """Parse with the C++ kseq-equivalent; returns a list of
    io.fasta.FastaRecord (None comment/qual preserved), or None when the
    library is unavailable. Raises OSError on open failure."""
    from aligntools_tpu_torch.io.fasta import FastaRecord

    lib = get_lib()
    if lib is None:
        return None
    h = lib.at_parse(path.encode(), max_records)
    try:
        if lib.at_parse_error(h):
            raise OSError(f"cannot open {path}")
        nrec = lib.at_num_records(h)
        if nrec == 0:
            return []
        asize = lib.at_arena_size(h)
        # empty std::vector data() is NULL — never wrap a NULL pointer
        buf = (
            np.ctypeslib.as_array(lib.at_arena(h), shape=(asize,)).tobytes()
            if asize > 0
            else b""
        )
        meta = np.ctypeslib.as_array(lib.at_records_meta(h), shape=(nrec, 8))
        out = []
        for (name_off, name_len, c_off, c_len, s_off, s_len, q_off,
             q_len) in meta.tolist():
            out.append(
                FastaRecord(
                    name=buf[name_off : name_off + name_len],
                    comment=(
                        buf[c_off : c_off + c_len] if c_off >= 0 else None
                    ),
                    seq=buf[s_off : s_off + s_len],
                    qual=buf[q_off : q_off + q_len] if q_off >= 0 else None,
                )
            )
        return out
    finally:
        lib.at_free(h)
