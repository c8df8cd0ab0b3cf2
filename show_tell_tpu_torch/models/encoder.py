"""The image encoder: frozen ResNet backbone + Linear/BatchNorm1d head
(counterpart of show_tell_tpu/models/encoder.py).

    pooled:   features = BN1d(Linear(mean_{h,w} resnet(images)))   [B, embed]
    spatial:  features = resnet(images) as [B, C, 49], p = 7*row + col

The backbone output is detached, as the reference detaches it (cnn.py:47):
the backbone runs under ``torch.no_grad()``, and only the head trains.  In
train mode (``Encoder.train()``) its BatchNorms still move their running
statistics, as the reference's ``cnn.train()`` does; the head's BN1d moves
its own with momentum 0.01 (cnn.py:38) and the unbiased variance.
The spatial mode (the attention families, cnn_attn.py:49) still creates the
Linear/BN1d head and never runs it: a dead parameter kept so that
checkpoints carry the same keys as the reference's.

``encode_u8`` is the serving entry, from uint8 pixels: the stock path runs
the preprocess kernel and the ResNet; the space-to-depth (s2d) path runs
the fused stem kernel from the pixels and the ResNet from its output.
``stem_u8`` is its first stage; its ``stem="conv"`` route, the preprocess
kernel in 12-channel mode and cuDNN's 4x4 conv1 (the JAX package's own
s2d composite), is the yardstick the fused stem is timed against.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from show_tell_tpu_torch.models.resnet import BatchNorm, ResNet, feature_dim, resnet_params_from_torch
from show_tell_tpu_torch.ops.preprocess import preprocess_u8
from show_tell_tpu_torch.ops.stem import prepare_stem, stem_fused

STEM_ROUTES = ("fused", "conv")
HEAD_BN_MOMENTUM = 0.01  # reference cnn.py:38


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
        self.last_layer = BatchNorm(cfg.embed_dim, momentum=HEAD_BN_MOMENTUM)
        self._stem: Optional[Dict[str, torch.Tensor]] = None

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 224, 224, 3] normalized float (NHWC), or its s2d
        layout [B, 112, 112, 12] -> [B, embed] pooled, or [B, C, 49]
        spatial: a view of the NHWC feature map, whose transpose(1, 2) is
        the contiguous positions-major [B, 49, C]."""
        with torch.no_grad():
            fmap = self.resnet(images)
        return self.head(fmap)

    def train(self, mode: bool = True) -> "Encoder":
        self._stem = None  # bn1's running statistics move in train mode
        return super().train(mode)

    def stem_operands(self) -> Dict[str, torch.Tensor]:
        """The fused stem's folded weight and bias map (ops/stem.py
        ``prepare_stem``), built from conv1 and bn1 at first use.  In eval
        mode they are kept: the backbone is frozen.  Train mode moves bn1's
        running statistics, so it drops them and builds them at each call."""
        if self._stem is None or self.training:
            self._stem = prepare_stem(self.resnet, self.resnet.conv1.weight.dtype)
        return self._stem

    def encode_u8(self, images_u8: torch.Tensor, s2d: bool = False) -> torch.Tensor:
        """uint8 pixels -> features, as ``forward`` returns them: ``stem_u8``
        (under s2d its "fused" route), layer1-4 and the head."""
        with torch.no_grad():
            fmap = self.resnet.forward_from_stem(self.stem_u8(images_u8, s2d))
        return self.head(fmap)

    def stem_u8(self, images_u8: torch.Tensor, s2d: bool = False, stem: str = "fused") -> torch.Tensor:
        """uint8 pixels -> the post-maxpool activation [B, 64, 56, 56]
        channels-last, as ``ResNet.forward_from_stem`` takes it.  s2d=False:
        [B, 224, 224, 3] through the preprocess kernel and the 7x7 conv1.
        s2d=True, routed by ``stem``: "fused" (served) takes [B, 224, 224,
        3] or its s2d layout [B, 112, 112, 12] into the stem kernel; "conv"
        (chip_smoke.py's A/B) takes [B, 112, 112, 12] through the
        preprocess kernel and the 4x4 conv1."""
        if s2d and stem not in STEM_ROUTES:
            raise ValueError("stem is one of %s, not %r" % (STEM_ROUTES, stem))
        if s2d and stem == "fused":
            return stem_fused(images_u8, self.stem_operands(), pool=True).permute(0, 3, 1, 2)
        channels = 12 if s2d else 3
        if images_u8.shape[-1] != channels:
            raise ValueError("this stem takes %d-channel images, got %s" % (channels, tuple(images_u8.shape)))
        return self.resnet.stem(preprocess_u8(images_u8, self.resnet.conv1.weight.dtype))

    def head(self, fmap: torch.Tensor) -> torch.Tensor:
        """The backbone's NHWC feature map -> the features ``forward`` returns."""
        fmap = fmap.detach()
        if self.spatial:
            B, h, w, C = fmap.shape
            return fmap.reshape(B, h * w, C).transpose(1, 2)
        pooled = fmap.mean(dim=(1, 2))
        return self.last_layer(self.linear_secondlast_layer(pooled))


# The reference wraps torchvision's children in nn.Sequential (cnn.py:34): index -> torchvision name.
# 2 (relu) and 3 (maxpool) hold no parameters.
_SEQUENTIAL_NAMES = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2", "6": "layer3", "7": "layer4"}


def encoder_params_from_torch(state_dict: Dict[str, Any], cfg: EncoderConfig) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A reference cnn.ResNet state_dict -> (params, state) numpy trees in the
    JAX layout (the counterpart of show_tell_tpu/models/encoder.py's
    ``encoder_params_from_torch``).  Keys: ``model.N.*`` (the Sequential
    index N maps back to torchvision's names, ``_SEQUENTIAL_NAMES``),
    ``linear_secondlast_layer.*`` and ``last_layer.*``;
    ``num_batches_tracked`` is dropped.  ``cfg`` is taken for the JAX
    signature: the keys carry every width."""
    from show_tell_tpu_torch.models.convert import _T, _np

    tv_sd: Dict[str, Any] = {}
    head: Dict[str, Dict[str, Any]] = {"linear_secondlast_layer": {}, "last_layer": {}, "state": {}}
    for k, v in state_dict.items():
        if k.startswith("model."):
            idx, _, tail = k[len("model."):].partition(".")
            name = _SEQUENTIAL_NAMES.get(idx)
            if name is not None:
                tv_sd[name + "." + tail if tail else name] = v
        elif k == "linear_secondlast_layer.weight":
            head["linear_secondlast_layer"]["w"] = _T(_np(v))
        elif k == "linear_secondlast_layer.bias":
            head["linear_secondlast_layer"]["b"] = _np(v)
        elif k in ("last_layer.weight", "last_layer.bias"):
            head["last_layer"][k.partition(".")[2]] = _np(v)
        elif k in ("last_layer.running_mean", "last_layer.running_var"):
            head["state"][k.partition(".")[2]] = _np(v)
    res_params, res_state = resnet_params_from_torch(tv_sd)
    params = {"resnet": res_params, "linear_secondlast_layer": head["linear_secondlast_layer"],
              "last_layer": head["last_layer"]}
    return params, {"resnet": res_state, "last_layer": head["state"]}
