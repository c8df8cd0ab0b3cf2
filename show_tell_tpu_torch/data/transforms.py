"""Device-side image preprocessing (counterpart of show_tell_tpu/data/transforms.py).

    uint8 [B,H,W,3] --(/255, optional per-sample flips, ImageNet normalize)--> float [B,H,W,3]

The public layout is NHWC, as in the JAX package; the encoder turns it
into channels-last NCHW internally.  The reference applies its random
flips at eval time too; ``augment`` controls them, and serving passes
``augment=False``.
"""

from __future__ import annotations

from typing import Optional

import torch

# ImageNet normalization constants (reference utils.py:88).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_images(
    images_u8: torch.Tensor,  # [B, H, W, 3] uint8
    generator: Optional[torch.Generator] = None,
    augment: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 [B,H,W,3] -> normalized [B,H,W,3] ``dtype``.  With augment,
    each sample is flipped horizontally, then vertically, each with an
    independent Bernoulli(0.5) draw from ``generator`` (which must live on
    the images' device)."""
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError("expected uint8 [B,H,W,3] images, got %s %s" % (images_u8.dtype, tuple(images_u8.shape)))
    x = images_u8.float() / 255.0
    if augment:
        if generator is None:
            raise ValueError("augment=True needs a torch.Generator")
        b = x.shape[0]
        hflip = torch.rand(b, 1, 1, 1, generator=generator, device=x.device) < 0.5
        vflip = torch.rand(b, 1, 1, 1, generator=generator, device=x.device) < 0.5
        x = torch.where(hflip, x.flip(2), x)
        x = torch.where(vflip, x.flip(1), x)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)
