"""ctypes loader for the native host kernels (native/silo_native.cpp at the
root of the repository, the same sources the JAX package builds).

Builds each shared library on first use if a C++ toolchain is present, with
native/Makefile, into build/native/ of the checkout: the port's own copies,
so that its builds never race the JAX package's writes into native/, and
under a file lock, so that processes of the port build one at a time.
Callers fall back to the numpy implementations when unavailable, so the
package works (slower) without a compiler. The NDJSON scanner always
builds against the declarations in native_include/zstd.h and the
libzstd.so.1 this process has loaded, so that it needs no zstd development
files.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_BUILD_DIR = os.path.join(_ROOT, "build", "native")
_lock = threading.Lock()
_lib = None
_tried = False


# native/Makefile's CXXFLAGS, repeated where a build adds to them
_MAKE_CXXFLAGS = "-O3 -march=native -fPIC -std=c++17 -Wall"
_ZSTD_INCLUDE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "native_include")


def _zstd_link_flags(build_dir: str) -> str:
    """CXXFLAGS that compile against native_include/zstd.h and link the
    libzstd.so.1 this process has loaded (through a libzstd.so link under
    `build_dir`)."""
    from .common import zstd  # noqa: F401 - loads libzstd.so.1

    with open("/proc/self/maps") as maps:
        loaded = next(line.split()[-1] for line in maps
                      if os.path.basename(line.split()[-1]).startswith(
                          "libzstd.so"))
    link_dir = os.path.join(build_dir, "zstd")
    os.makedirs(link_dir, exist_ok=True)
    link = os.path.join(link_dir, "libzstd.so")
    if os.path.lexists(link):
        os.unlink(link)
    os.symlink(loaded, link)
    return f"CXXFLAGS={_MAKE_CXXFLAGS} -I{_ZSTD_INCLUDE} -L{link_dir}"


def _build_and_load(so_name: str, build_dir: str = _BUILD_DIR):
    """`so_name` built from native/ into `build_dir` (make is a no-op when
    it is fresh) and loaded; None when it cannot be built."""
    path = os.path.join(build_dir, so_name)
    if os.path.isdir(_NATIVE_DIR):
        os.makedirs(build_dir, exist_ok=True)
        with open(os.path.join(build_dir, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                flags = ([_zstd_link_flags(build_dir)]
                         if so_name == "libsilo_ndjson.so" else [])
                subprocess.run(
                    ["make", "-C", build_dir, "-f",
                     os.path.join(_NATIVE_DIR, "Makefile"),
                     f"--eval=vpath %.cpp {_NATIVE_DIR}", *flags, so_name],
                    check=True, capture_output=True, timeout=120)
            except Exception as ex:  # noqa: BLE001
                logger.info("native build of %s unavailable (%s); using the "
                            "Python fallbacks", so_name, ex)
            if os.path.exists(path):
                return ctypes.CDLL(path)
    return None


_named_libs: dict = {}


def get_named_lib(so_name: str):
    """Load (building if needed) another shared library of native/, e.g.
    libsilo_http.so. Returns None when unavailable."""
    with _lock:
        if so_name not in _named_libs:
            _named_libs[so_name] = _build_and_load(so_name)
        return _named_libs[so_name]


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = _build_and_load("libsilo_native.so")
        if lib is None:
            return None
        try:
            lib.silo_pack_batch_compact.restype = None
            lib.silo_pack_batch_compact.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ]
            lib.silo_presence.restype = None
            lib.silo_presence.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ]
        except AttributeError:
            logger.info("stale libsilo_native.so without compact kernels; "
                        "using numpy fallbacks")
            return None
        lib.silo_chars_to_ids.restype = ctypes.c_int32
        lib.silo_chars_to_ids.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def pack_batch_compact(ids, rows, row_map, row_offset: int,
                       n_threads: int | None = None) -> bool:
    """Scatter ids[batch, length] into compact rows[cap, W] through
    row_map[S, length] (negatives = implicit, no write). Returns False if
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    import numpy as np

    assert ids.dtype == np.uint8 and ids.flags.c_contiguous
    assert rows.dtype == np.uint32 and rows.flags.c_contiguous
    assert row_map.dtype == np.int32 and row_map.flags.c_contiguous
    batch, length = ids.shape
    assert row_map.shape[1] == length
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 8)
    lib.silo_pack_batch_compact(
        ids.ctypes.data, batch, length, rows.ctypes.data,
        rows.shape[1], row_map.ctypes.data, row_offset, n_threads,
    )
    return True


def presence(ids, n_symbols: int):
    """uint8[S*L] presence marks for a batch, or None if native is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    assert ids.dtype == np.uint8 and ids.flags.c_contiguous
    batch, length = ids.shape
    out = np.zeros(n_symbols * length, dtype=np.uint8)
    lib.silo_presence(ids.ctypes.data, batch, length, out.ctypes.data)
    return out
