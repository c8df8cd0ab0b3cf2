"""Image files -> the uint8 batches the Captioner takes.

Decoding and resizing are PIL's, as the JAX package's parity reference
(show_tell_tpu/serve.py ``_pil_load``): RGB, bilinear to 224 x 224.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

IMAGE_SIZE = 224  # the encoder's input side (the JAX package's data/dataset.py)


def load_images(paths: Sequence[str]) -> np.ndarray:
    """Image files -> uint8 [N, 224, 224, 3]."""
    from PIL import Image

    rows = []
    for path in paths:
        with Image.open(path) as img:
            rows.append(np.asarray(img.convert("RGB").resize((IMAGE_SIZE, IMAGE_SIZE), Image.BILINEAR), np.uint8))
    return np.stack(rows)
