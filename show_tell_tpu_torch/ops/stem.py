"""The fused ResNet stem of the s2d serving path: its operands
(``prepare_stem``), the kernel (csrc/stem.cu), its plain twin and its
launch count (counterpart of show_tell_tpu/ops/stem_pallas.py).

    uint8 image -> normalize + conv1 + eval BN + relu (+ 3x3/s2 maxpool)
                -> [B, 56, 56, 64] (or [B, 112, 112, 64]) NHWC, compute dtype

The normalize never runs as elementwise math: its per-channel scale folds
into the weights, and its shift passes through the convolution as a
constant map t, zero where a tap falls on conv1's zero padding (which
comes after normalization).  The image is the s2d layout [B, 112, 112, 12]
or RGB [B, 224, 224, 3]; the kernel reads either without a relayout.
The pooled output's NHWC memory is the channels-last memory of
[B, 64, 56, 56], so ``ResNet.forward_from_stem(y.permute(0, 3, 1, 2))``
takes it without a copy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from show_tell_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from show_tell_tpu_torch.ops import check_tensor, dtype_code, raise_on_error, stream_arg, uses_kernel
from show_tell_tpu_torch.ops.s2d_stem import S2D_PAD, space_to_depth, transform_conv1_weight

S2D_SIDE, CHANNELS, TAPS = 112, 64, 192  # the 224 image's s2d side; conv1's outputs; 4 x 4 x 12
# A row (column) of t belongs to one of four classes, 0, 1, 2..110 or 111, by which of the taps it reads fall
# on conv1's padding; CLASS_REPS names one row (column) of each, so tc = t[CLASS_REPS][:, CLASS_REPS].
CLASS_REPS = (0, 1, 2, S2D_SIDE - 1)
LAYOUTS = {(S2D_SIDE, S2D_SIDE, 12): 0, (2 * S2D_SIDE, 2 * S2D_SIDE, 3): 1}  # the kernel's `layout` argument


def prepare_stem(resnet, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """conv1 + bn1 (eval) + normalize -> the kernel's operands, on the
    ResNet's device: {"w": [192, 64] ``dtype``, conv1 as the 4x4 s2d
    kernel with BN's multiplier gamma / sqrt(var + eps) and the scale
    1 / (255 std_c) folded in, rows in (a, b, di, dj, c) order; "t":
    [112, 112, 64] f32, the shift -mean_c / std_c through the convolution
    where taps lie inside the image, plus BN's bias; "tc": [4, 4, 64] f32,
    t's 16 distinct vectors, t at rows and columns CLASS_REPS (both
    kernels read tc, the twin t)}.  Folded in f32 on
    the CPU (no TF32), then moved; w is rounded to ``dtype`` once."""
    from show_tell_tpu_torch.models.resnet import BN_EPS

    cpu = lambda v: v.detach().to("cpu", torch.float32)
    bn = resnet.bn1
    mult = cpu(bn.weight) * torch.rsqrt(cpu(bn.running_var) + BN_EPS)
    w4 = transform_conv1_weight(cpu(resnet.conv1.weight)) * mult[:, None, None, None]  # [64, 12, 4, 4]
    bias = cpu(bn.bias) - cpu(bn.running_mean) * mult

    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    scale = torch.from_numpy(np.tile(1.0 / (255.0 * std), 4).astype(np.float32))  # [12], channel (di, dj, c)
    shift = torch.from_numpy(np.tile(-mean / std, 4).astype(np.float32))
    tmask = torch.zeros(1, 12, S2D_SIDE + 3, S2D_SIDE + 3)  # the padded s2d image: 2 before, 1 after
    tmask[:, :, 2:S2D_SIDE + 2, 2:S2D_SIDE + 2] = shift[:, None, None]
    tmap = F.conv2d(tmask, w4)[0] + bias[:, None, None]  # [64, 112, 112]
    w = (w4 * scale[None, :, None, None]).permute(2, 3, 1, 0).reshape(TAPS, CHANNELS)
    t = tmap.permute(1, 2, 0).contiguous()
    reps = list(CLASS_REPS)
    device = resnet.conv1.weight.device
    return {"w": w.to(device, dtype).contiguous(), "t": t.to(device), "tc": t[reps][:, reps].contiguous().to(device)}


def _layout(images_u8: torch.Tensor) -> int:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or tuple(images_u8.shape[1:]) not in LAYOUTS:
        raise ValueError("stem_fused takes uint8 [B,112,112,12] (s2d) or [B,224,224,3] images, got %s %s"
                         % (images_u8.dtype, tuple(images_u8.shape)))
    return LAYOUTS[tuple(images_u8.shape[1:])]


def stem_fused_plain(images_u8: torch.Tensor, prepared: Dict[str, torch.Tensor], pool: bool = True) -> torch.Tensor:
    """The kernel's function in plain torch ops: each f32 sum runs over
    the 192 taps in the f32 (SIMT) kernel's order (a, then c12, then b)
    starting from 0, then + t, relu, maxpool, rounded once to the compute
    dtype, in NHWC.  In f32 the two differ by the twin's rounding of each
    product (the kernel's fused multiply-add does not round it).  With
    bf16 weights every product of a pixel and a weight is exact in f32,
    but the bf16 kernel adds them on the tensor cores in another order
    (k16 steps, and within one the hardware's), so its f32 sums differ
    from the twin's in the last bits and the bf16 outputs by at most one
    bf16 ulp where a sum sits near a rounding boundary."""
    if _layout(images_u8) == 1:
        images_u8 = space_to_depth(images_u8)
    w = prepared["w"]
    x = F.pad(images_u8.permute(0, 3, 1, 2).float(), S2D_PAD)  # [B, 12, 115, 115]: taps off the image read 0
    wf = w.float().reshape(TAPS, CHANNELS, 1, 1)
    B, side = x.shape[0], S2D_SIDE
    acc = torch.zeros(B, CHANNELS, side, side, device=x.device)
    for a in range(4):
        for k in range(12):
            for b in range(4):
                acc.addcmul_(x[:, k : k + 1, a : a + side, b : b + side], wf[(a * 4 + b) * 12 + k])
    y = F.relu(acc + prepared["t"].permute(2, 0, 1))
    if pool:
        y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(w.dtype).contiguous()


def stem_fused_cuda(images_u8: torch.Tensor, prepared: Dict[str, torch.Tensor], pool: bool = True) -> torch.Tensor:
    """Launch the kernel on the current stream.  images_u8 uint8 [B,112,112,12]
    or [B,224,224,3]; prepared w [192, 64] (f32: the SIMT kernel; bf16:
    the tensor-core kernel) and tc [4, 4, 64] f32; both
    on one CUDA device, contiguous.  Raises on anything else and on a
    failed launch."""
    from show_tell_tpu_torch.ops.build import load_library

    layout = _layout(images_u8)
    B, device = images_u8.shape[0], images_u8.device
    w, tc = prepared["w"], prepared["tc"]
    code = dtype_code("stem_fused", w.dtype)
    check_tensor("images_u8", images_u8, images_u8.shape, torch.uint8, device)
    check_tensor("stem w", w, (TAPS, CHANNELS), w.dtype, device)
    check_tensor("stem tc", tc, (len(CLASS_REPS), len(CLASS_REPS), CHANNELS), torch.float32, device)
    side = S2D_SIDE // 2 if pool else S2D_SIDE
    out = torch.empty(B, side, side, CHANNELS, dtype=w.dtype, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.st_stem(code, layout, int(pool), images_u8.data_ptr(), w.data_ptr(), tc.data_ptr(), out.data_ptr(), B,
                          stream_arg(device))
    raise_on_error("stem_fused", err)
    stem_fused.launches += 1
    return out


def stem_fused(images_u8: torch.Tensor, prepared: Dict[str, torch.Tensor], pool: bool = True) -> torch.Tensor:
    """uint8 image -> the post-stem activation, NHWC in the compute dtype
    (counterpart of stem_pallas.stem_fused_pallas).  CUDA tensors launch
    the kernel (and count the launch in ``stem_fused.launches``); CPU
    tensors run the plain twin."""
    if uses_kernel(images_u8):
        return stem_fused_cuda(images_u8, prepared, pool)
    return stem_fused_plain(images_u8, prepared, pool)


stem_fused.launches = 0
