"""ResNet-18/34/50/101/152 backbones as nn.Modules
(counterpart of show_tell_tpu/models/resnet.py).

Parameter and buffer names are torchvision's ("layer1.0.conv1.weight",
"bn1.running_mean", ...), the names the JAX package keys its flat dicts
by.  BatchNorm follows the module's mode: eval runs from the running
statistics (serving), train normalizes by the batch's statistics and moves
the running ones (the reference trains its frozen backbone in train mode,
``cnn.train()``); the final fc layer is never created (the reference
strips it, cnn.py:34).  Input and output are
NHWC at the public boundary; inside, activations are channels-last NCHW,
the layout cuDNN's NHWC convolutions take.

A 12-channel input is the space-to-depth layout (data/transforms.py): conv1
then runs as the equivalent 4x4/s1 convolution with padding (2, 1), its
weight rearranged from the 7x7 one (ops/s2d_stem.py).  ``forward_from_stem``
starts after the stem, from the post-maxpool activation, which the fused
stem kernel (ops/stem.py) computes straight from uint8 pixels.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from show_tell_tpu_torch.ops.s2d_stem import S2D_PAD, transform_conv1_weight

BN_EPS = 1e-5

# (block_type, blocks per stage) per version.
RESNET_SPECS: Dict[int, Tuple[str, List[int]]] = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}

STAGE_WIDTHS = [64, 128, 256, 512]


def feature_dim(version: int) -> int:
    return 512 if RESNET_SPECS[version][0] == "basic" else 2048


class BatchNorm(nn.Module):
    """BatchNorm over axis 1 of [B, C, ...]: weight/bias parameters and
    running_mean/running_var buffers (no num_batches_tracked, so the keys
    match the JAX dicts).  Eval mode normalizes by the running statistics.
    Train mode (the JAX package's ``_bn(training=True)``) normalizes by the
    batch's biased variance over every axis but 1 and moves the running
    statistics by ``momentum`` towards the batch mean and the unbiased
    variance (n = B x H x W), which is ``F.batch_norm``'s own rule.  With
    ``mesh`` set (a data-parallel run), train mode takes the mean and
    variance of every rank's rows (``parallel.mesh.synced_batch_norm``)."""

    def __init__(self, c: int, momentum: float = 0.1):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.mesh = None  # a data-parallel mesh (parallel/mesh.py): train mode then takes every rank's statistics

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.mesh is not None:
            from show_tell_tpu_torch.parallel.mesh import synced_batch_norm

            return synced_batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var, self.momentum,
                                     BN_EPS, self.mesh)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=self.training, momentum=self.momentum, eps=BN_EPS)


def _conv(cin: int, cout: int, k: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Block(nn.Module):
    """Basic (two 3x3) or bottleneck (1x1, 3x3, 1x1) residual block."""

    def __init__(self, kind: str, cin: int, width: int, stride: int):
        super().__init__()
        self.kind = kind
        cout = width if kind == "basic" else width * 4
        if kind == "basic":
            self.conv1, self.bn1 = _conv(cin, width, 3, stride), BatchNorm(width)
            self.conv2, self.bn2 = _conv(width, width, 3, 1), BatchNorm(width)
        else:
            self.conv1, self.bn1 = _conv(cin, width, 1, 1), BatchNorm(width)
            self.conv2, self.bn2 = _conv(width, width, 3, stride), BatchNorm(width)
            self.conv3, self.bn3 = _conv(width, cout, 1, 1), BatchNorm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        if self.kind == "basic":
            h = self.bn2(self.conv2(h))
        else:
            h = F.relu(self.bn2(self.conv2(h)))
            h = self.bn3(self.conv3(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNet(nn.Module):
    def __init__(self, version: int):
        super().__init__()
        kind, stages = RESNET_SPECS[version]
        self.version = version
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for s, n_blocks in enumerate(stages):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and s > 0) else 1
                blocks.append(Block(kind, cin, STAGE_WIDTHS[s], stride))
                cin = STAGE_WIDTHS[s] * (1 if kind == "basic" else 4)
            self.add_module("layer%d" % (s + 1), nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] normalized float, or its s2d layout [B, H/2, W/2,
        12] -> features [B, H/32, W/32, C]."""
        return self.forward_from_stem(self.stem(x))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """x as ``forward`` takes it -> conv1, bn1, relu and the maxpool ->
        [B, 64, H/4, W/4] channels-last."""
        y = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if y.shape[1] == 12:
            y = F.conv2d(F.pad(y, S2D_PAD), transform_conv1_weight(self.conv1.weight))
        else:
            y = self.conv1(y)
        y = F.relu(self.bn1(y))
        return F.max_pool2d(y, kernel_size=3, stride=2, padding=1)  # implicit -inf padding

    def forward_from_stem(self, y: torch.Tensor) -> torch.Tensor:
        """The post-maxpool activation [B, 64, H/4, W/4] (channels-last, as
        ``stem.permute(0, 3, 1, 2)`` of an NHWC tensor gives it) -> layer1-4
        -> features [B, H/32, W/32, C]."""
        for s in range(4):
            y = getattr(self, "layer%d" % (s + 1))(y)
        return y.permute(0, 2, 3, 1)


def resnet_params_from_torch(state_dict: Dict[str, Any]) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """A torchvision ResNet state_dict -> (params, state) flat numpy dicts in
    the JAX layout (the counterpart of show_tell_tpu/models/resnet.py's
    ``resnet_params_from_torch``), for ``init_captioner``'s trees: conv
    weights OIHW -> HWIO; ``fc.*`` and ``num_batches_tracked`` are dropped
    (the reference strips fc, cnn.py:34).  Every array is a copy."""
    params: Dict[str, np.ndarray] = {}
    state: Dict[str, np.ndarray] = {}
    for k, v in state_dict.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        arr = np.array(v.detach().cpu().numpy() if torch.is_tensor(v) else v, copy=True)
        if k.endswith(".weight") and arr.ndim == 4:
            params[k] = np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0)))  # OIHW->HWIO
        elif k.endswith(".running_mean") or k.endswith(".running_var"):
            state[k] = arr
        else:
            params[k] = arr
    return params, state
