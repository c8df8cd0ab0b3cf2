"""Serving-time BatchNorm folding (counterpart of show_tell_tpu/models/serving.py).

For inference the encoder's BatchNorms run in eval mode, an affine map of
the running statistics, so each conv + BN pair folds into one biased
convolution (per output channel):

    w' = w * gamma / sqrt(var + eps)
    b' = beta - mean * gamma / sqrt(var + eps)

and the pooled head's Linear + BatchNorm1d into one Linear.  The folded
trees (``fold_resnet_bn``, ``fold_encoder``) are the JAX package's: flat
torchvision names, HWIO convolutions with a ``.bias`` beside each, no BN
keys; the fold runs in f32 on the CPU and casts to the compute dtype last.

``FoldedEncoder`` serves them with ``Encoder``'s surface (``encode_u8``,
``stem_u8``, ``head``, ``forward``): every convolution is one biased cuDNN
convolution, channels-last.  On a GPU the ReLU after a convolution, and
the residual add and ReLU that close a block, run in the convolution's
epilogue (``torch.cudnn_convolution_relu`` and
``torch.cudnn_convolution_add_relu``, cuDNN's own fused calls); on the CPU
they are separate torch ops.  The stock path runs the preprocess kernel
and the folded ResNet; the s2d path runs the stem kernel, which folds
conv1's BN itself (ops/stem.py), from the folded conv1's operands, then the
folded layer1-4.  ``Captioner(fold_bn=...)`` picks the route
(``ops.fold_bn_default()`` when the caller does not say).  Training and
``test_model`` never fold: training runs train-mode BN, and the JAX tester
does not fold either.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from show_tell_tpu_torch.models.encoder import Encoder, EncoderConfig
from show_tell_tpu_torch.models.resnet import BN_EPS, RESNET_SPECS, STAGE_WIDTHS, feature_dim
from show_tell_tpu_torch.ops.s2d_stem import S2D_PAD, transform_conv1_weight
from show_tell_tpu_torch.ops.stem import stem_operands


def _f32(x) -> torch.Tensor:
    """An array or tensor -> an f32 CPU tensor of its own."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32, copy=True)
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _bn_of(conv: str) -> str:
    """The BN that follows a convolution, by torchvision's names."""
    if conv == "conv1":
        return "bn1"
    if conv.endswith(".downsample.0"):
        return conv[:-1] + "1"
    return conv.replace(".conv", ".bn")  # layerX.Y.convN -> layerX.Y.bnN


def fold_resnet_bn(params: Dict[str, Any], state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flat torchvision-keyed ResNet params (HWIO convolutions) and running
    statistics -> the folded biased convolutions, f32 CPU tensors."""
    folded: Dict[str, torch.Tensor] = {}
    for k, w in params.items():
        if not (k.endswith(".weight") and np.ndim(w) == 4):
            continue
        conv = k[: -len(".weight")]
        bn = _bn_of(conv)
        mult = _f32(params[bn + ".weight"]) * torch.rsqrt(_f32(state[bn + ".running_var"]) + BN_EPS)
        folded[k] = _f32(w) * mult  # HWIO: the output channel is last
        folded[conv + ".bias"] = _f32(params[bn + ".bias"]) - _f32(state[bn + ".running_mean"]) * mult
    return folded


def fold_encoder(params: Dict[str, Any], state: Dict[str, Any],
                 dtype: Optional[torch.dtype] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """An encoder's (params, state) trees -> {"resnet": folded convolutions,
    "head": {"w" [C, E], "b" [E]}}: the head's Linear + BatchNorm1d as one
    Linear, y = x (W m) + ((b - mean) m + beta), m = gamma / sqrt(var + eps).
    Folded in f32, then cast to ``dtype`` where given."""
    lin, bn, bs = params["linear_secondlast_layer"], params["last_layer"], state["last_layer"]
    m = _f32(bn["weight"]) * torch.rsqrt(_f32(bs["running_var"]) + BN_EPS)
    out = {
        "resnet": fold_resnet_bn(params["resnet"], state["resnet"]),
        "head": {"w": _f32(lin["w"]) * m, "b": (_f32(lin["b"]) - _f32(bs["running_mean"])) * m + _f32(bn["bias"])},
    }
    if dtype is not None:
        out = {part: {k: v.to(dtype) for k, v in tree.items()} for part, tree in out.items()}
    return out


def _conv_relu(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return torch.cudnn_convolution_relu(x, conv.weight, conv.bias, conv.stride, conv.padding, conv.dilation, 1)
    return F.relu(conv(x))


def _conv_add_relu(conv: nn.Conv2d, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """relu(conv(x) + z), the close of a residual block."""
    if x.is_cuda:
        return torch.cudnn_convolution_add_relu(x, conv.weight, z, 1.0, conv.bias, conv.stride, conv.padding,
                                                conv.dilation, 1)
    return F.relu(conv(x) + z)


def _biased(cin: int, cout: int, k: int, stride: int, padding: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=True)


class FoldedBlock(nn.Module):
    """``resnet.Block`` with each BN folded into its convolution."""

    def __init__(self, kind: str, cin: int, width: int, stride: int):
        super().__init__()
        self.kind = kind
        cout = width if kind == "basic" else width * 4
        if kind == "basic":
            self.conv1, self.conv2 = _biased(cin, width, 3, stride, 1), _biased(width, width, 3, 1, 1)
        else:
            self.conv1 = _biased(cin, width, 1, 1, 0)
            self.conv2 = _biased(width, width, 3, stride, 1)
            self.conv3 = _biased(width, cout, 1, 1, 0)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_biased(cin, cout, 1, stride, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv_relu(self.conv1, x)
        last = self.conv2
        if self.kind != "basic":
            h = _conv_relu(self.conv2, h)
            last = self.conv3
        identity = x if self.downsample is None else self.downsample(x)
        return _conv_add_relu(last, h, identity)


class FoldedResNet(nn.Module):
    """``resnet.ResNet`` in eval mode with every BN folded: the same names
    for the convolutions (each with a bias), no BN, the same ``stem`` and
    ``forward_from_stem`` boundaries (NHWC in, NHWC features out,
    channels-last inside)."""

    def __init__(self, version: int):
        super().__init__()
        kind, stages = RESNET_SPECS[version]
        self.conv1 = _biased(3, 64, 7, 2, 3)
        cin = 64
        for s, n_blocks in enumerate(stages):
            blocks = []
            for b in range(n_blocks):
                blocks.append(FoldedBlock(kind, cin, STAGE_WIDTHS[s], 2 if (b == 0 and s > 0) else 1))
                cin = STAGE_WIDTHS[s] * (1 if kind == "basic" else 4)
            self.add_module("layer%d" % (s + 1), nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_from_stem(self.stem(x))

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC [B, H, W, 3], or its s2d layout [B, H/2, W/2,
        12] -> conv1 (+ bias), relu, maxpool -> [B, 64, H/4, W/4] channels-last."""
        y = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        if y.shape[1] == 12:
            y = F.relu(F.conv2d(F.pad(y, S2D_PAD), transform_conv1_weight(self.conv1.weight), self.conv1.bias))
        else:
            y = _conv_relu(self.conv1, y)
        return F.max_pool2d(y, kernel_size=3, stride=2, padding=1)

    def forward_from_stem(self, y: torch.Tensor) -> torch.Tensor:
        for s in range(4):
            y = getattr(self, "layer%d" % (s + 1))(y)
        return y.permute(0, 2, 3, 1)


class FoldedEncoder(nn.Module):
    """The eval-mode encoder on folded weights (the counterpart of
    ``folded_encoder_forward``), with ``models/encoder.Encoder``'s serving
    surface.  Build it with ``from_trees``."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.spatial = cfg.spatial
        self.resnet = FoldedResNet(cfg.resnet_version)
        self.linear = nn.Linear(feature_dim(cfg.resnet_version), cfg.embed_dim)
        self._stem: Dict[str, torch.Tensor] = {}

    @classmethod
    def from_trees(cls, params: Dict[str, Any], state: Dict[str, Any], cfg: EncoderConfig, dtype: torch.dtype,
                   device: torch.device) -> "FoldedEncoder":
        """An encoder's (params, state) trees in the JAX layout -> a
        FoldedEncoder on ``device`` in ``dtype`` (eval mode, no gradients):
        ``fold_encoder`` in f32, the s2d stem's operands from the f32
        folded conv1, then the cast."""
        folded = fold_encoder(params, state)
        sd = {"resnet." + k: (v.permute(3, 2, 0, 1) if v.dim() == 4 else v) for k, v in folded["resnet"].items()}
        sd["linear.weight"] = folded["head"]["w"].t()
        sd["linear.bias"] = folded["head"]["b"]
        with torch.device("meta"):  # no default init: every tensor comes from the fold
            enc = cls(cfg)
        enc.load_state_dict({k: v.contiguous() for k, v in sd.items()}, strict=True, assign=True)
        enc = enc.to(device=device, dtype=dtype).eval().requires_grad_(False)
        enc.resnet.to(memory_format=torch.channels_last)
        enc._stem = stem_operands(transform_conv1_weight(sd["resnet.conv1.weight"]), sd["resnet.conv1.bias"], dtype,
                                  device)
        return enc

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC float images (or their s2d layout) -> features, as ``Encoder.forward``."""
        return self.head(self.resnet(images))

    def stem_operands(self) -> Dict[str, torch.Tensor]:
        """The stem kernel's operands (ops/stem.py), from the folded conv1."""
        return self._stem

    # Encoder's serving entries, on the folded modules: the stem kernel (s2d "fused") or the preprocess kernel and
    # the folded conv1 (``FoldedResNet.stem``), then the folded layer1-4 and ``head``.
    encode_u8 = Encoder.encode_u8
    stem_u8 = Encoder.stem_u8

    def head(self, fmap: torch.Tensor) -> torch.Tensor:
        """The NHWC feature map -> [B, E] pooled (the folded Linear), or the
        [B, C, P] spatial view, as ``Encoder.head``."""
        if self.spatial:
            B, h, w, C = fmap.shape
            return fmap.reshape(B, h * w, C).transpose(1, 2)
        return self.linear(fmap.mean(dim=(1, 2)))
