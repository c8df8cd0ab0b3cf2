"""Device resolution for ``--device cpu|gpu``.

``gpu`` means the first CUDA device and raises when there is none: the
port never moves to the CPU on its own.
"""

from __future__ import annotations

from typing import Union

import torch

DEVICE_CHOICES = ("cpu", "gpu")


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """'cpu' | 'gpu' | a torch.device (or its string) -> torch.device."""
    if isinstance(device, str) and device == "gpu":
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but torch finds no CUDA device" % device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError("show_tell_tpu_torch runs on cpu or gpu, not %s" % device)
    return device
