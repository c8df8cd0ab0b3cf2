"""The image encoder: frozen ResNet backbone + Linear/BatchNorm1d head
(counterpart of show_tell_tpu/models/encoder.py, eval).

    pooled:   features = BN1d(Linear(mean_{h,w} resnet(images)))   [B, embed]
    spatial:  features = resnet(images) as [B, C, 49], p = 7*row + col

The backbone output is detached, as the reference detaches it (cnn.py:47).
The spatial mode (the attention families, cnn_attn.py:49) still creates the
Linear/BN1d head and never runs it: a dead parameter kept so that
checkpoints carry the same keys as the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from show_tell_tpu_torch.models.resnet import FrozenBatchNorm, ResNet, feature_dim


class EncoderConfig(NamedTuple):
    resnet_version: int
    embed_dim: int
    spatial: bool = False  # True: the attention families' [B, C, 49] features


class Encoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.spatial = cfg.spatial
        self.resnet = ResNet(cfg.resnet_version)
        self.linear_secondlast_layer = nn.Linear(feature_dim(cfg.resnet_version), cfg.embed_dim)
        self.last_layer = FrozenBatchNorm(cfg.embed_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 224, 224, 3] normalized float (NHWC) -> [B, embed]
        pooled, or [B, C, 49] spatial: a view of the NHWC feature map,
        whose transpose(1, 2) is the contiguous positions-major [B, 49, C]."""
        fmap = self.resnet(images).detach()
        if self.spatial:
            B, h, w, C = fmap.shape
            return fmap.reshape(B, h * w, C).transpose(1, 2)
        pooled = fmap.mean(dim=(1, 2))
        return self.last_layer(self.linear_secondlast_layer(pooled))
