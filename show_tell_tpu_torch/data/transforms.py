"""Device-side image preprocessing (counterpart of show_tell_tpu/data/transforms.py).

    uint8 [B,H,W,3] --(/255, optional per-sample flips, ImageNet normalize)--> float [B,H,W,3]

The public layout is NHWC, as in the JAX package; the encoder turns it
into channels-last NCHW internally.  The reference applies its random
flips at eval time too; ``augment`` controls them, and serving passes
``augment=False``.

The space-to-depth (s2d) layout moves each 2x2 pixel block into channels:
uint8 [B,224,224,3] -> [B,112,112,12], channel k = (di, dj, c) =
6*di + 3*dj + c.  ``host_space_to_depth`` emits it on the host (same
bytes), and ``preprocess_images_s2d`` normalizes it on the device; the
encoder's s2d stem runs conv1 on it as a 4x4/s1 convolution
(ops/s2d_stem.py).

Serving normalizes through ``ops.preprocess.preprocess_u8`` (the kernel
on a GPU); the functions here are its plain twin and the augmenting form.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# ImageNet normalization constants (reference utils.py:88).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _flip_draws(b: int, generator: Optional[torch.Generator], device: torch.device):
    """Per-sample (horizontal, vertical) Bernoulli(0.5) flips, drawn in
    that order with shape [b, 1, 1, 1] each on the generator's device (a
    CPU generator flips CUDA images as it flips their CPU copy), so that
    the stock and the s2d preprocess flip the same samples from the same
    generator state.  The copies to a GPU are queued without a stream sync
    (non_blocking from fresh host tensors), so a step can queue behind the
    card's work."""
    if generator is None:
        raise ValueError("augment=True needs a torch.Generator")
    hflip = torch.rand(b, 1, 1, 1, generator=generator, device=generator.device) < 0.5
    vflip = torch.rand(b, 1, 1, 1, generator=generator, device=generator.device) < 0.5
    return hflip.to(device, non_blocking=True), vflip.to(device, non_blocking=True)


def _normalize(x: torch.Tensor, reps: int, dtype: torch.dtype) -> torch.Tensor:
    """(x - mean_c) / std_c with the RGB constants tiled ``reps`` times
    along the last axis (channel k holds colour k % 3); the constants are
    copied to a GPU without a stream sync, as in ``_flip_draws``."""
    mean = torch.tensor(IMAGENET_MEAN * reps, dtype=torch.float32).to(x.device, non_blocking=True)
    std = torch.tensor(IMAGENET_STD * reps, dtype=torch.float32).to(x.device, non_blocking=True)
    return ((x - mean) / std).to(dtype)


def preprocess_images(
    images_u8: torch.Tensor,  # [B, H, W, 3] uint8
    generator: Optional[torch.Generator] = None,
    augment: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 [B,H,W,3] -> normalized [B,H,W,3] ``dtype``.  With augment,
    each sample is flipped horizontally, then vertically, each with an
    independent Bernoulli(0.5) draw from ``generator``."""
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError("expected uint8 [B,H,W,3] images, got %s %s" % (images_u8.dtype, tuple(images_u8.shape)))
    x = images_u8.float() / 255.0
    if augment:
        hflip, vflip = _flip_draws(x.shape[0], generator, x.device)
        x = torch.where(hflip, x.flip(2), x)
        x = torch.where(vflip, x.flip(1), x)
    return _normalize(x, 1, dtype)


def host_space_to_depth(images_u8: np.ndarray) -> np.ndarray:
    """Host relayout: uint8 [B,H,W,3] -> [B,H/2,W/2,12], channel order
    (di, dj, c).  Same bytes, so the host-to-device copy costs the same."""
    B, H, W, C = images_u8.shape
    x = images_u8.reshape(B, H // 2, 2, W // 2, 2, C)
    return np.ascontiguousarray(x.transpose(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C))


def preprocess_images_s2d(
    images_u8: torch.Tensor,  # [B, H/2, W/2, 12] s2d uint8
    generator: Optional[torch.Generator] = None,
    augment: bool = True,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The s2d twin of ``preprocess_images``: normalization indexes the
    RGB constants by k % 3, and the flips are exact in s2d coordinates
    (horizontal: reverse the W/2 axis and swap dj; vertical: reverse H/2
    and swap di), so the result is ``host_space_to_depth`` of the stock
    preprocess of the same pixels with the same generator."""
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 12:
        raise ValueError("expected uint8 [B,H/2,W/2,12] s2d images, got %s %s"
                         % (images_u8.dtype, tuple(images_u8.shape)))
    x = images_u8.float() / 255.0
    if augment:
        B, H2, W2, C12 = x.shape
        hflip, vflip = _flip_draws(B, generator, x.device)
        xg = x.reshape(B, H2, W2, 2, 2, 3)  # [.., di, dj, c]
        xg = torch.where(hflip.reshape(B, 1, 1, 1, 1, 1), xg.flip(2, 4), xg)
        xg = torch.where(vflip.reshape(B, 1, 1, 1, 1, 1), xg.flip(1, 3), xg)
        x = xg.reshape(B, H2, W2, C12)
    return _normalize(x, 4, dtype)
