"""Image files -> the uint8 batches the Captioner takes.

As the JAX package's ``Captioner.load_files`` does (show_tell_tpu/serve.py):
the native libjpeg decoder (native/fastimage.py) where it builds, with PIL
for each file it rejects (not a JPEG, or damaged); PIL alone where it does
not build.  Both give RGB, resized to 224 x 224 by PIL's antialiased
bilinear filter; ``pil_load`` is the JAX package's ``_pil_load``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

IMAGE_SIZE = 224  # the encoder's input side (the JAX package's data/dataset.py)


def pil_load(path: str) -> np.ndarray:
    """One image file -> uint8 [224, 224, 3] through PIL."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB").resize((IMAGE_SIZE, IMAGE_SIZE), Image.BILINEAR), np.uint8)


def load_images(paths: Sequence[str], fast_jpeg: bool = False) -> np.ndarray:
    """Image files -> uint8 [N, 224, 224, 3].  fast_jpeg: the native
    decoder's DCT-domain scaled decode (a few LSB from the full decode;
    the PIL fallback ignores it, as in the JAX package)."""
    from show_tell_tpu_torch.native import fastimage

    if not fastimage.is_available():
        return np.stack([pil_load(p) for p in paths])
    bufs = []
    for p in paths:
        with open(p, "rb") as f:
            bufs.append(f.read())
    batch, statuses = fastimage.decode_resize_batch(bufs, IMAGE_SIZE, IMAGE_SIZE, fast_scale=fast_jpeg)
    for i, s in enumerate(statuses):
        if s != 0:
            batch[i] = pil_load(paths[i])
    return batch
