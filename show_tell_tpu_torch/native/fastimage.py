"""ctypes binding of the native JPEG decoder (the port's own copy of
show_tell_tpu/native/fastimage.py, RGB output only).

``decode_resize_batch`` decodes and resizes a batch of JPEGs on host
threads that hold no GIL; ``data/images.load_images`` uses it where the
library builds and falls back to PIL for each file it rejects.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_path = ""  # the loaded library
_why = ""  # why the library is not there, once a build was tried
_lock = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _path, _why
    with _lock:
        if _lib is None and not _why:
            from show_tell_tpu_torch.native.build import build

            path, _why = build()
            if path:
                try:
                    lib = ctypes.CDLL(path)
                except OSError as e:
                    _why = "the library does not load: %s" % e
                    return None
                c_int, c_ptr = ctypes.c_int, ctypes.POINTER
                lib.st_decode_resize_batch3.restype = c_int
                lib.st_decode_resize_batch3.argtypes = [
                    c_ptr(ctypes.c_char_p), c_ptr(ctypes.c_size_t), c_int, c_int, c_int, c_ptr(ctypes.c_uint8),
                    c_ptr(c_int), c_int, c_int, c_int,
                ]
                _lib, _path = lib, path
        return _lib


def is_available() -> bool:
    """True where the library builds (g++ and libjpeg) and loads."""
    return _load() is not None


def status() -> str:
    """Which decoder ``load_images`` runs here, and why: "native (path)" or
    "PIL (the reason the library is missing)"."""
    return "native (%s)" % _path if _load() is not None else "PIL (%s)" % _why


def decode_resize_batch(
    jpeg_buffers: Sequence[bytes],
    out_h: int,
    out_w: int,
    n_threads: int = 0,
    fast_scale: bool = False,
) -> Tuple[np.ndarray, List[int]]:
    """JPEG bytes -> (uint8 [N, out_h, out_w, 3] RGB, per-image statuses,
    0 for a decoded image).  ``fast_scale``: libjpeg's DCT-domain scaled
    decode, which emits the smallest M/8 reduction that still covers the
    target before the resize (pixels within a few LSB of the full decode).
    Rows whose status is not 0 are left undefined."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native JPEG decoder is not available: %s" % _why)
    n = len(jpeg_buffers)
    out = np.empty((n, out_h, out_w, 3), dtype=np.uint8)
    statuses = (ctypes.c_int * n)()
    bufs = (ctypes.c_char_p * n)(*jpeg_buffers)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in jpeg_buffers])
    if n_threads <= 0:
        n_threads = min(max(os.cpu_count() or 1, 1), max(n, 1))
    lib.st_decode_resize_batch3(bufs, lens, n, out_h, out_w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                statuses, n_threads, 1 if fast_scale else 0, 0)
    return out, list(statuses)
