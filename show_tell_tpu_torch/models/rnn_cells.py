"""Plain GRU cell and stack step with PyTorch gate conventions
(counterpart of show_tell_tpu/models/rnn_cells.py, GRU half).

Gate order r, z, n; double biases; the reset gate multiplies the
hidden-side affine:
    r = sigma(x W_ir^T + b_ir + h W_hr^T + b_hr)
    z = sigma(x W_iz^T + b_iz + h W_hz^T + b_hz)
    n = tanh (x W_in^T + b_in + r * (h W_hn^T + b_hn))
    h' = (1 - z) n + z h
Weights are in the torch layout (w_ih [3H, in], w_hh [3H, H]).  Sums and
gate math run in f32 and h' is cast back to the carry dtype.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from show_tell_tpu_torch.ops.rnn import gru_cell_math


def gru_cell(layer: Dict[str, torch.Tensor], x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step. x [B, in], h [B, H] -> h' [B, H] in h's dtype."""
    return gru_cell_math(x, h, layer["w_ih"], layer["w_hh"], layer["b_ih"], layer["b_hh"], h.dtype)


def stack_step_gru(
    layers: List[Dict[str, torch.Tensor]], x: torch.Tensor, hs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step through all layers. hs [L, B, H] -> (top h [B, H], new hs)."""
    new_hs = []
    inp = x
    for l, layer in enumerate(layers):
        inp = gru_cell(layer, inp, hs[l])
        new_hs.append(inp)
    return inp, torch.stack(new_hs)
