"""On-disk decoded-image cache: JPEG decode once, train 100 epochs (the
port's own copy of show_tell_tpu/data/image_cache.py).

The dataset is annotation-keyed (reference utils.py:32 — one sample per
caption, ~5 captions per COCO image), so the naive pipeline decodes the
SAME image ~5x per epoch and re-decodes everything every epoch.  Because
augmentation (random flips, normalize) runs on the device inside the
train step (data/transforms.py), the host-side product per image is a fixed
pre-augment uint8 224x224x3 array — exactly cacheable.  This cache
memmaps one [n_images, H, W, 3] uint8 file per dataset; first touch
decodes and fills the row, every later access (same epoch or any later
epoch) is a page-cached memcpy.  ~150KB/image (~12.5GB for COCO
train2014) on disk; opt-in via --image_cache DIR.

Thread-safety: loader threads may decode the same image concurrently
(two captions of one image in one batch) — both write identical bytes,
and the valid flag is set only after the row write, so the benign race
costs at most a duplicate decode.  Cross-process init (e.g.
a prefill script racing a training run) is safe too: the backing
files are created exclusively (O_CREAT|O_EXCL) so a second process can
never truncate rows the first already filled.

Staleness caveat: cache identity covers file NAMES, size, and decode
mode — not image file CONTENTS.  If an image on disk is replaced after
its row was filled, the stale decoded row keeps being served; delete
the cache directory after changing image files.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import numpy as np


def _open_shared_memmap(path: str, shape) -> np.memmap:
    """Create-or-open a shared memmap WITHOUT the mode='w+' truncation
    race: two processes initializing the same cache concurrently must
    never zero rows the other already filled (and flagged valid)."""
    nbytes = int(np.prod(shape))
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR)
        try:
            os.ftruncate(fd, nbytes)
        finally:
            os.close(fd)
    except FileExistsError:
        # Creator won the race; wait out its (microseconds-long) window
        # between create and ftruncate so the fixed-shape mapping below
        # doesn't see a short file.
        for _ in range(2000):
            if os.path.getsize(path) >= nbytes:
                break
            time.sleep(0.002)
        if os.path.getsize(path) < nbytes:  # creator died mid-init
            fd = os.open(path, os.O_RDWR)
            try:
                os.ftruncate(fd, nbytes)  # extend only; filled rows keep
            finally:
                os.close(fd)
    return np.memmap(path, dtype=np.uint8, mode="r+", shape=shape)


class ImageCache:
    """Memmap-backed uint8 image cache keyed by image file name."""

    def __init__(self, cache_dir: str, file_names: List[str], image_size: int, fast_jpeg: bool = False):
        os.makedirs(cache_dir, exist_ok=True)
        self.image_size = image_size
        names = sorted(set(file_names))
        self.row = {name: i for i, name in enumerate(names)}
        n = len(names)
        index_path = os.path.join(cache_dir, "index.json")
        data_path = os.path.join(cache_dir, "images_u8.dat")
        valid_path = os.path.join(cache_dir, "valid.dat")
        # The decode mode is part of the cache identity: a cache filled
        # with --fast_jpeg holds few-LSB-off pixels that must not be
        # silently served to a later parity run (and vice versa).
        index = {"image_size": image_size, "fast_jpeg": bool(fast_jpeg), "files": names}
        if os.path.isfile(index_path):
            with open(index_path) as f:
                on_disk = json.load(f)
            if on_disk != index:
                raise ValueError(
                    "image cache at %s was built for a different dataset, size, or "
                    "decode mode (fast_jpeg); point --image_cache at a fresh directory"
                    % cache_dir
                )
        else:
            with open(index_path + ".tmp", "w") as f:
                json.dump(index, f)
            os.replace(index_path + ".tmp", index_path)
        self.data = _open_shared_memmap(data_path, (n, image_size, image_size, 3))
        self.valid = _open_shared_memmap(valid_path, (n,))

    def get(self, file_name: str) -> Optional[np.ndarray]:
        """Cached pixels for this image, or None when absent (first
        touch, or a name outside the index)."""
        i = self.row.get(file_name)
        if i is not None and self.valid[i]:
            # Read-only view: zero-copy, and an accidental in-place
            # mutation raises instead of silently corrupting the
            # on-disk cache for every later run.
            view = self.data[i].view()
            view.flags.writeable = False
            return view
        return None

    def put(self, file_name: str, image: np.ndarray) -> None:
        i = self.row.get(file_name)
        if i is None:  # name outside the index: don't cache, don't crash
            return
        self.data[i] = image
        # Flush the row before publishing validity: dirty-page writeback
        # order is unspecified, so without this a machine crash mid-fill
        # could persist valid=1 over an unwritten row.  msync only the
        # row's page range — a whole-mapping flush would walk every PTE
        # of a multi-GB mapping on each put.
        import mmap as _mmap

        row_bytes = self.image_size * self.image_size * 3
        start = (i * row_bytes // _mmap.PAGESIZE) * _mmap.PAGESIZE
        length = (i + 1) * row_bytes - start
        try:
            self.data._mmap.flush(start, length)  # noqa: SLF001 — no public row flush
        except (AttributeError, ValueError, OSError):
            self.data.flush()
        self.valid[i] = 1  # after the row write: readers never see torn rows

    def hit_fraction(self) -> float:
        return float(np.mean(self.valid))
