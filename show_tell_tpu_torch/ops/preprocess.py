"""The serving preprocess of uint8 images: the kernel (csrc/preprocess.cu),
its plain twin and its launch count (counterpart of
show_tell_tpu/ops/preprocess_pallas.py).

    uint8 [B,H,W,C] -> ((x / 255) - mean_c) / std_c  in float32 or bfloat16

C is 3 (RGB) or 12 (the space-to-depth layout, whose channel k holds
colour k % 3).  Serving only: no flips (``augment=False``).  The plain
twin is data/transforms.py's ``preprocess_images`` (C=3) or
``preprocess_images_s2d`` (C=12), and the kernel repeats its arithmetic as
PyTorch runs it on the card, so the two agree bit for bit there.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from show_tell_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    preprocess_images,
    preprocess_images_s2d,
)
from show_tell_tpu_torch.ops import check_tensor, dtype_code, raise_on_error, stream_arg, uses_kernel

CHANNELS = (3, 12)
# On the card, ``x / 255.0`` multiplies by the float32 reciprocal of 255
# (PyTorch's CUDA division by a CPU scalar); the kernel does the same.
INV255 = float(np.float32(1.0) / np.float32(255.0))


def _check_images(images_u8: torch.Tensor) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] not in CHANNELS:
        raise ValueError("preprocess_u8 takes uint8 [B,H,W,3] or [B,H/2,W/2,12] images, got %s %s"
                         % (images_u8.dtype, tuple(images_u8.shape)))


def preprocess_u8_plain(images_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's function in plain torch ops."""
    _check_images(images_u8)
    if images_u8.shape[-1] == 3:
        return preprocess_images(images_u8, augment=False, dtype=dtype)
    return preprocess_images_s2d(images_u8, augment=False, dtype=dtype)


def preprocess_u8_cuda(images_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Launch the kernel on the current stream.  images_u8 uint8 [B,H,W,3]
    or [B,H,W,12] on a CUDA device, contiguous and 16-byte aligned.
    Raises on anything else and on a failed launch."""
    from show_tell_tpu_torch.ops.build import load_library

    _check_images(images_u8)
    code = dtype_code("preprocess_u8", dtype)
    device = images_u8.device
    check_tensor("images_u8", images_u8, images_u8.shape, torch.uint8, device)
    out = torch.empty(images_u8.shape, dtype=dtype, device=device)
    f = lambda v: ctypes.c_float(float(np.float32(v)))  # the float32 constants the twin's tensors hold
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.st_preprocess(code, images_u8.data_ptr(), out.data_ptr(), images_u8.numel(), f(INV255),
                                *(f(m) for m in IMAGENET_MEAN), *(f(s) for s in IMAGENET_STD), stream_arg(device))
    raise_on_error("preprocess_u8", err)
    preprocess_u8.launches += 1
    return out


def preprocess_u8(images_u8: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 images (RGB or s2d layout) -> normalized ``dtype`` in the same
    layout (counterpart of preprocess_pallas.preprocess_images_pallas).
    CUDA tensors launch the kernel (and count the launch in
    ``preprocess_u8.launches``); CPU tensors run the plain twin."""
    if uses_kernel(images_u8):
        return preprocess_u8_cuda(images_u8, dtype)
    return preprocess_u8_plain(images_u8, dtype)


preprocess_u8.launches = 0
