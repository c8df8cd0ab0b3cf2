"""The pooled image encoder: frozen ResNet backbone + Linear/BatchNorm1d head
(counterpart of show_tell_tpu/models/encoder.py, pooled mode, eval).

    features = BN1d(Linear(mean_{h,w} resnet(images)))      [B, embed]

The backbone output is detached, as the reference detaches it (cnn.py:47).
The spatial mode of the attention families waits for their slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from show_tell_tpu_torch.models.resnet import FrozenBatchNorm, ResNet, feature_dim


class EncoderConfig(NamedTuple):
    resnet_version: int
    embed_dim: int
    spatial: bool = False  # True (attention families) is not ported yet


class Encoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        if cfg.spatial:
            raise NotImplementedError(
                "the spatial encoder of the attention families is ROADMAP Queue 1 item 12"
            )
        self.resnet = ResNet(cfg.resnet_version)
        self.linear_secondlast_layer = nn.Linear(feature_dim(cfg.resnet_version), cfg.embed_dim)
        self.last_layer = FrozenBatchNorm(cfg.embed_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 224, 224, 3] normalized float (NHWC) -> [B, embed]."""
        fmap = self.resnet(images).detach()
        pooled = fmap.mean(dim=(1, 2))
        return self.last_layer(self.linear_secondlast_layer(pooled))
