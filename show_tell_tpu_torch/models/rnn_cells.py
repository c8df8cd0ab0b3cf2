"""Plain GRU and LSTM cells, stack steps and the teacher-forced stack
over time, with PyTorch gate conventions (counterpart of
show_tell_tpu/models/rnn_cells.py).

GRU gate order r, z, n; double biases; the reset gate multiplies the
hidden-side affine:
    r = sigma(x W_ir^T + b_ir + h W_hr^T + b_hr)
    z = sigma(x W_iz^T + b_iz + h W_hz^T + b_hz)
    n = tanh (x W_in^T + b_in + r * (h W_hn^T + b_hn))
    h' = (1 - z) n + z h
LSTM gate order i, f, g, o; double biases; c' = f c + i g, h' = o tanh(c').
Weights are in the torch layout (w_ih [G*H, in], w_hh [G*H, H]).  Sums and
gate math run in f32 and h' (and c') are cast back to the carry dtype.  A
stack's state is hs [L, B, H] for the GRU and (hs, cs) for the LSTM.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from show_tell_tpu_torch.ops.rnn import State, gru_cell_math, gru_gate_math, lstm_cell_math, lstm_gate_math


def gru_cell(layer: Dict[str, torch.Tensor], x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step. x [B, in], h [B, H] -> h' [B, H] in h's dtype."""
    return gru_cell_math(x, h, layer["w_ih"], layer["w_hh"], layer["b_ih"], layer["b_hh"], h.dtype)


def lstm_cell(
    layer: Dict[str, torch.Tensor], x: torch.Tensor, hc: Tuple[torch.Tensor, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step. x [B, in], (h, c) [B, H] each -> (h', c') in their dtypes."""
    h, c = hc
    return lstm_cell_math(x, h, c, layer["w_ih"], layer["w_hh"], layer["b_ih"], layer["b_hh"], h.dtype, c.dtype)


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


def stack_step_lstm(
    layers: List[Dict[str, torch.Tensor]], x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One step through all layers. state (hs, cs) -> (top h [B, H], (new hs, new cs))."""
    hs, cs = state
    new_hs, new_cs = [], []
    inp = x
    for l, layer in enumerate(layers):
        inp, c2 = lstm_cell(layer, inp, (hs[l], cs[l]))
        new_hs.append(inp)
        new_cs.append(c2)
    return inp, (torch.stack(new_hs), torch.stack(new_cs))


def stack_step(cell_type: str):
    return stack_step_lstm if cell_type == "lstm" else stack_step_gru


def init_state(cell_type: str, num_layers: int, batch: int, hidden: int, dtype: torch.dtype, device=None):
    """Zeros in ``dtype``: hs for the GRU, (hs, cs) for the LSTM."""
    hs = torch.zeros(num_layers, batch, hidden, dtype=dtype, device=device)
    return (hs, torch.zeros_like(hs)) if cell_type == "lstm" else hs


def rnn_scan(layers: List[Dict[str, torch.Tensor]], cell_type: str, inputs: torch.Tensor,
             state: State) -> Tuple[torch.Tensor, State]:
    """Run the stack over time: inputs [B, T, in] -> (outputs [B, T, H] of
    the top layer, final state).  Layer-major, as the JAX package's
    ``rnn_scan``: per layer, the input side of every step is one [B*T, in] x
    [in, G*H] product summed in f32 (+ b_ih), and only the h side and the
    gate math run step by step.  Outputs and the carry keep ``state``'s dtype."""
    lstm = cell_type == "lstm"
    seq = inputs
    finals_h, finals_c = [], []
    for l, layer in enumerate(layers):
        gx_all = seq.float() @ layer["w_ih"].float().T + layer["b_ih"].float()  # [B, T, G*H]
        h = state[0][l] if lstm else state[l]
        c = state[1][l] if lstm else None
        outs = []
        for t in range(seq.shape[1]):
            if lstm:
                h, c = lstm_gate_math(gx_all[:, t], h, c, layer["w_hh"], layer["b_hh"], h.dtype, c.dtype)
            else:
                h = gru_gate_math(gx_all[:, t], h, layer["w_hh"], layer["b_hh"], h.dtype)
            outs.append(h)
        seq = torch.stack(outs, dim=1)
        finals_h.append(h)
        finals_c.append(c)
    hs = torch.stack(finals_h)
    return seq, ((hs, torch.stack(finals_c)) if lstm else hs)
