"""ctypes loader for the native host kernels (native/silo_native.cpp at the
root of the repository, the same sources the JAX package builds).

Auto-builds the shared library on first use if a C++ toolchain is present;
callers fall back to the numpy implementations when unavailable, so the
package works (slower) without a compiler.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libsilo_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "all"], check=True,
                       capture_output=True, timeout=120)
        return True
    except Exception as ex:  # noqa: BLE001
        logger.info("native build unavailable (%s); using numpy fallbacks", ex)
        return False


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.path.isdir(_NATIVE_DIR):
            _build()  # make is a no-op when the .so is fresh
        if not os.path.exists(_SO_PATH):
            return None
        lib = ctypes.CDLL(_SO_PATH)
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
