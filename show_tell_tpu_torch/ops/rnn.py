"""GRU and LSTM decode math, the stack-step kernels (the recurrence alone,
csrc/fused_step.cu) and the greedy decode's routes over the step kernels
(counterpart of show_tell_tpu/ops/rnn_pallas.py).

Weights stay in the torch layout [G*H, in] (G = 3 gates for the GRU, 4
for the LSTM; one contiguous row per gate column), which is what the CUDA
kernels stream.  Layer 0 keeps its own input width I0 (E for the pooled
decoder, 2E for attention), smaller or larger than H:
``prepare_rnn_weights`` stacks it apart from the upper layers, as
ops/fused_attn_pallas.py does on the TPU.  A recurrent state is hs
[L, B, H] for the GRU and the tuple (hs, cs) for the LSTM.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from show_tell_tpu_torch.ops import uses_kernel

LstmState = Tuple[torch.Tensor, torch.Tensor]  # (hs, cs), each [L, B, H]
State = Union[torch.Tensor, LstmState]  # hs, or the LSTM's (hs, cs)


def gru_cell_math(x, h, w_ih, w_hh, b_ih, b_hh, out_dtype: torch.dtype) -> torch.Tensor:
    """One GRU cell: products summed in f32, gate math in f32 (torch gate
    order r, z, n; double biases; the reset gate multiplies the hidden-side
    affine W_hn h + b_hn), result cast to the carry dtype.  Mirrors
    rnn_pallas.gru_cell_math; w_ih [3H, in], w_hh [3H, H]."""
    gx = x.float() @ w_ih.float().T + b_ih.float()
    return gru_gate_math(gx, h, w_hh, b_hh, out_dtype)


def gru_gate_math(gx, h, w_hh, b_hh, out_dtype: torch.dtype) -> torch.Tensor:
    """``gru_cell_math`` from its x side ``gx = x w_ih^T + b_ih`` [B, 3H]
    (f32), computed apart: the h side and the gate math."""
    H = h.shape[-1]
    gh = h.float() @ w_hh.float().T + b_hh.float()
    r = torch.sigmoid(gx[:, :H] + gh[:, :H])
    z = torch.sigmoid(gx[:, H : 2 * H] + gh[:, H : 2 * H])
    n = torch.tanh(gx[:, 2 * H :] + r * gh[:, 2 * H :])
    return ((1.0 - z) * n + z * h.float()).to(out_dtype)


def lstm_cell_math(
    x, h, c, w_ih, w_hh, b_ih, b_hh, h_dtype: torch.dtype, c_dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM cell (torch gate order i, f, g, o; double biases): the sum
    x w_ih^T + b_ih + h w_hh^T + b_hh in f32, c' = f c + i g in f32 and
    h' = o tanh(c') from that f32 c'; only then are h' and c' cast to their
    carry dtypes.  Mirrors rnn_pallas.lstm_cell_math; w_ih [4H, in], w_hh
    [4H, H].  Returns (h', c')."""
    return lstm_gate_math(x.float() @ w_ih.float().T + b_ih.float(), h, c, w_hh, b_hh, h_dtype, c_dtype)


def lstm_gate_math(
    gx, h, c, w_hh, b_hh, h_dtype: torch.dtype, c_dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lstm_cell_math`` from its x side ``gx = x w_ih^T + b_ih`` [B, 4H]
    (f32), computed apart: gx + h w_hh^T + b_hh, summed in that order, and
    the gate math."""
    H = h.shape[-1]
    g = gx + h.float() @ w_hh.float().T + b_hh.float()
    i = torch.sigmoid(g[:, :H])
    f = torch.sigmoid(g[:, H : 2 * H])
    gg = torch.tanh(g[:, 2 * H : 3 * H])
    o = torch.sigmoid(g[:, 3 * H :])
    c2 = f * c.float() + i * gg
    return (o * torch.tanh(c2)).to(h_dtype), c2.to(c_dtype)


def prepare_rnn_weights(
    layers: List[Dict[str, torch.Tensor]], dtype: Optional[torch.dtype] = None
) -> Dict[str, torch.Tensor]:
    """Stack per-layer {w_ih [G*H,in], w_hh [G*H,H], b_ih [G*H], b_hh [G*H]}
    (G, the gate count, read from w_hh) into w_ih0 [G*H, I0] (layer 0, its
    own input width), w_ihU [L-1, G*H, H] (the upper layers; empty for
    L=1), w_hh [L, G*H, H] and b_ih/b_hh [L, G*H].  Done once per model,
    outside the decode loop."""
    GH, H = layers[0]["w_hh"].shape
    dtype = dtype or layers[0]["w_hh"].dtype
    stack = lambda ts: torch.stack([t.to(dtype) for t in ts]).contiguous()
    w_ihU = [l["w_ih"] for l in layers[1:]]
    return {
        "w_ih0": layers[0]["w_ih"].to(dtype).contiguous(),
        "w_ihU": stack(w_ihU) if w_ihU else layers[0]["w_hh"].new_empty((0, GH, H), dtype=dtype),
        "w_hh": stack([l["w_hh"] for l in layers]),
        "b_ih": stack([l["b_ih"] for l in layers]),
        "b_hh": stack([l["b_hh"] for l in layers]),
    }


def _layer_weights(stacked: Dict[str, torch.Tensor], l: int):
    w_ih = stacked["w_ih0"] if l == 0 else stacked["w_ihU"][l - 1]
    return w_ih, stacked["w_hh"][l], stacked["b_ih"][l], stacked["b_hh"][l]


def gru_stack_plain(
    stacked: Dict[str, torch.Tensor], x: torch.Tensor, hs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence of a fused decode step in plain torch ops: the
    ``prepare_rnn_weights`` layers over x [B, I0] and hs [L, B, H], each
    by ``gru_cell_math``.  Returns (top h [B, H], new_hs [L, B, H])."""
    inp, new_hs = x.to(hs.dtype), []
    for l in range(hs.shape[0]):
        inp = gru_cell_math(inp, hs[l], *_layer_weights(stacked, l), hs.dtype)
        new_hs.append(inp)
    return inp, torch.stack(new_hs)


def lstm_stack_plain(
    stacked: Dict[str, torch.Tensor], x: torch.Tensor, state: LstmState
) -> Tuple[torch.Tensor, LstmState]:
    """The LSTM twin of ``gru_stack_plain``: state (hs, cs), each [L, B, H],
    each layer by ``lstm_cell_math``.  Returns (top h [B, H], (new_hs,
    new_cs))."""
    hs, cs = state
    inp, new_hs, new_cs = x.to(hs.dtype), [], []
    for l in range(hs.shape[0]):
        inp, c2 = lstm_cell_math(inp, hs[l], cs[l], *_layer_weights(stacked, l), hs.dtype, cs.dtype)
        new_hs.append(inp)
        new_cs.append(c2)
    return inp, (torch.stack(new_hs), torch.stack(new_cs))


def stack_plain(cell_type: str):
    """The plain stack step of a cell: ``(stacked, x, state) -> (top, state)``
    (rnn_cells.stack_step's role in the JAX package's composite paths)."""
    return lstm_stack_plain if cell_type == "lstm" else gru_stack_plain


def gru_stack_step_cuda(stacked, x, hs, splits: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the GRU stack-step kernel (csrc/fused_step.cu, the kNone end)
    on the current stream: the fused step's checks, no vocab operands.  In
    bf16 it runs on the tensor cores (csrc/dense_mma.cuh) with each layer's
    K split across S blocks, S by ``fused_step.stack_tiles`` (``splits``:
    that S for every layer instead); f32 runs the SIMT code.  Raises on
    anything it does not take and on a failed launch."""
    from show_tell_tpu_torch.ops.fused_step import launch_fused_step

    out = launch_fused_step("gru_stack_step", stacked, None, x, hs, None, splits)
    gru_stack_step.launches += 1
    return out


def lstm_stack_step_cuda(stacked, x, state: LstmState, splits: int = 0) -> Tuple[torch.Tensor, LstmState]:
    """Launch the LSTM stack-step kernel; the GRU kernel's rules, with cs
    [L, B, H] held like hs."""
    from show_tell_tpu_torch.ops.fused_step import launch_fused_step

    out = launch_fused_step("lstm_stack_step", stacked, None, x, state, None, splits)
    lstm_stack_step.launches += 1
    return out


def gru_stack_step(
    stacked: Dict[str, torch.Tensor], x: torch.Tensor, hs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the L-layer GRU stack (counterpart of
    rnn_pallas.gru_stack_step_pallas): x [B, I0], hs [L, B, H] -> (top
    [B, H], new_hs [L, B, H]).  CUDA tensors launch the kernel (and count
    the launch in ``gru_stack_step.launches``); CPU tensors run
    ``gru_stack_plain``."""
    if uses_kernel(hs):
        return gru_stack_step_cuda(stacked, x, hs)
    return gru_stack_plain(stacked, x, hs)


def lstm_stack_step(
    stacked: Dict[str, torch.Tensor], x: torch.Tensor, state: LstmState
) -> Tuple[torch.Tensor, LstmState]:
    """The LSTM stack step (counterpart of rnn_pallas.lstm_stack_step_pallas):
    (hs, cs) -> (top [B, H], (new_hs, new_cs)).  CUDA tensors launch the
    kernel (``lstm_stack_step.launches``); CPU tensors run ``lstm_stack_plain``."""
    if uses_kernel(state[0]):
        return lstm_stack_step_cuda(stacked, x, state)
    return lstm_stack_plain(stacked, x, state)


gru_stack_step.launches = 0
lstm_stack_step.launches = 0


def prepare_greedy(
    layers: List[Dict[str, torch.Tensor]],
    embedding: torch.Tensor,  # [V, E]
    linear_w: torch.Tensor,  # [V, H]
    linear_b: torch.Tensor,  # [V]
    dtype: Optional[torch.dtype] = None,
) -> Dict[str, object]:
    """Everything the greedy loop reads, in kernel layout, built once:
    stacked recurrence weights, the projection, and the embedding table,
    whose fed-back rows are the kernel's layer-0 input as they stand."""
    from show_tell_tpu_torch.ops.vocab import prepare_vocab

    stacked = prepare_rnn_weights(layers, dtype)
    dtype = stacked["w_hh"].dtype
    return {
        "stacked": stacked,
        "vocab": prepare_vocab(linear_w, linear_b, dtype),
        "embedding": embedding.to(dtype).contiguous(),
    }


def greedy_decode_kernel(
    prepared: Dict[str, object],  # prepare_greedy output
    feats: torch.Tensor,  # [B, E] image features
    max_len: int,
    end_token: Optional[int] = None,
    whole_decode: Optional[bool] = None,
    vocab_sharded: bool = False,
) -> torch.Tensor:
    """Greedy decode (counterpart of rnn_pallas.greedy_decode_pallas), by
    the stacked weights' gate count; returns [B, max_len] int32 ids.

    Routes, as the JAX package dispatches them:
      * the whole-decode kernel (ops/whole_decode.py), one launch for all
        max_len steps, when ``whole_decode`` (None: ``whole_decode_default()``),
        ``end_token`` is None, the cell is the GRU and the projection is
        not sharded;
      * ``vocab_sharded``: per token the stack-step kernel, the projection
        ``top @ w.T + b`` in f32 outside any kernel and the first-max
        argmax (the JAX package leaves that product to XLA);
      * otherwise one fused-step launch per token
        (``fused_{gru,lstm}_decode_step``).
    The per-token routes feed back ``x = embedding[tok]`` from a zero state
    in the compute dtype, hs and (LSTM) cs alike.  end_token: stop once
    every row emitted it (<pad> after it)."""
    from show_tell_tpu_torch.models.decoder import greedy_loop
    from show_tell_tpu_torch.models.rnn_cells import init_state
    from show_tell_tpu_torch.ops import whole_decode_default
    from show_tell_tpu_torch.ops.fused_step import fused_gru_decode_step, fused_lstm_decode_step
    from show_tell_tpu_torch.ops.vocab import first_max_argmax, project_logits
    from show_tell_tpu_torch.ops.whole_decode import gru_whole_greedy_decode

    stacked, vocab, embedding = prepared["stacked"], prepared["vocab"], prepared["embedding"]
    L, GH, H = stacked["w_hh"].shape
    cell = "lstm" if GH == 4 * H else "gru"
    if whole_decode is None:
        whole_decode = whole_decode_default()
    if whole_decode and end_token is None and cell == "gru" and not vocab_sharded:
        return gru_whole_greedy_decode(prepared, feats, max_len)
    x0 = feats.to(embedding.dtype).contiguous()
    state0 = init_state(cell, L, feats.shape[0], H, embedding.dtype, feats.device)
    if vocab_sharded:
        stack = lstm_stack_step if cell == "lstm" else gru_stack_step

        def step(x, state):
            top, state2 = stack(stacked, x, state)
            return first_max_argmax(project_logits(vocab, top)), state2

    else:
        fused = fused_lstm_decode_step if cell == "lstm" else fused_gru_decode_step

        def step(x, state):
            return fused(stacked, vocab, x, state)

    return greedy_loop(step, embedding, x0, state0, max_len, end_token)
