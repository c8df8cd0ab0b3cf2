"""Decoded-image cache for the serving CLI, ``--image_cache DIR`` (the
port's own copy of show_tell_tpu/data/serve_cache.py).

One ``.npy`` per image, keyed by a hash of (absolute path, file size,
mtime_ns, image size, fast_jpeg), the JAX package's key, so a replaced
image file decodes anew and unrelated serve runs can share one directory.  Writes are atomic
(a temporary file, then a rename), so concurrent serve processes can
share it too; a duplicated decode is the worst a race costs.  An entry
that does not load as the expected uint8 [size, size, 3] counts as a miss
and decodes anew.  Entries are always the RGB layout, whatever layout the
Captioner serves.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional

import numpy as np


class ServeImageCache:
    def __init__(self, cache_dir: str, image_size: int, fast_jpeg: bool = False):
        """fast_jpeg: the entries are (to be) decoded with the native
        decoder's scaled decode (data/images.load_images)."""
        os.makedirs(cache_dir, exist_ok=True)
        self.dir = cache_dir
        self.image_size = image_size
        self.fast_jpeg = bool(fast_jpeg)
        self.hits = 0
        self.misses = 0

    def _key(self, path: str) -> Optional[str]:
        try:
            st = os.stat(path)
        except OSError:
            return None
        ident = "%s|%d|%d|%d|%d" % (os.path.abspath(path), st.st_size, st.st_mtime_ns, self.image_size, self.fast_jpeg)
        return hashlib.sha1(ident.encode()).hexdigest()

    def get(self, path: str) -> Optional[np.ndarray]:
        """The cached uint8 [size, size, 3] pixels of ``path``, or None (a miss)."""
        key = self._key(path)
        if key is None:
            return None
        try:
            arr = np.load(os.path.join(self.dir, key + ".npy"))
        except (OSError, ValueError):
            self.misses += 1
            return None
        if arr.shape != (self.image_size, self.image_size, 3) or arr.dtype != np.uint8:
            self.misses += 1  # a corrupt or foreign entry decodes anew
            return None
        self.hits += 1
        return arr

    def put(self, path: str, image: np.ndarray) -> None:
        key = self._key(path)
        if key is None:
            return
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, np.ascontiguousarray(image))
            os.replace(tmp, os.path.join(self.dir, key + ".npy"))
        except OSError:
            pass  # a cache that cannot be written only costs a decode next time
        finally:
            if os.path.exists(tmp):  # failed before the rename, any cause
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
