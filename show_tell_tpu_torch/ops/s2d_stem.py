"""The space-to-depth form of ResNet's conv1 (counterpart of
show_tell_tpu/ops/s2d_stem.py, in torch's OIHW layout).

conv1 is a 7x7/s2 convolution with padding 3 on [B,224,224,3].  Moving
each 2x2 pixel block into channels ([B,112,112,12], channel (di, dj, c))
turns it into a 4x4/s1 convolution with padding (2, 1) on both spatial
axes, with the same taps regrouped: output row p reads input rows
2p-3..2p+3, which in s2d rows i = row // 2 is i in [p-2, p+1].  The 4x4
kernel is the 7x7 one grown to 8x8 by a leading zero row and column:

    w4[o, di*6 + dj*3 + c, a, b] = w8[o, c, 2a+di, 2b+dj]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

S2D_PAD = (2, 1, 2, 1)  # F.pad order (left, right, top, bottom): conv1's pad 3 in s2d coordinates


def transform_conv1_weight(w7: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, 3, 7, 7] stride-2 kernel -> [Cout, 12, 4, 4] s2d kernel."""
    O, C, H, W = w7.shape
    if (H, W) != (7, 7):
        raise ValueError("transform_conv1_weight takes a 7x7 kernel, got %dx%d" % (H, W))
    w8 = F.pad(w7, (1, 0, 1, 0))  # index -1 -> 0 on both spatial axes
    w4 = w8.reshape(O, C, 4, 2, 4, 2)  # [o, c, a, di, b, dj]
    return w4.permute(0, 3, 5, 1, 2, 4).reshape(O, 4 * C, 4, 4).contiguous()


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B,H,W,C] -> [B,H/2,W/2,4C], channel order (di, dj, c)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)


def stem_s2d(x: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """NHWC [B,H,W,3] -> conv1's NCHW output; equals
    ``F.conv2d(x, w7, stride=2, padding=3)`` for w4 = transform(w7)."""
    xs = space_to_depth(x).permute(0, 3, 1, 2)
    return F.conv2d(F.pad(xs, S2D_PAD), w4)
